#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-only   # the decode kernels' phase-4
                                          # rows and phase 9's windows

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device: the card's name and ``nvidia-smi`` name and power limit;
  2. build: compiles ``kernels/csrc/paged_decode.cu``, ``paged_verify.cu``,
     ``flash_attention.cu``, ``rmsnorm.cu``, ``flash_decode.cu``,
     ``moe_gmm.cu`` and ``ssd_scan.cu`` for sm_90a, all nvcc runs at once
     (seconds; each kernel's registers, shared memory and spills; where
     ``cuobjdump`` is installed, each library's count of HMMA tensor-core
     instructions, at least one in ``paged_verify.cu`` and in
     ``ssd_scan.cu``; which
     instantiation of flash attention, the grouped matmul, paged decode
     and paged verify runs for which dtype and D or C; paged decode's
     launch plan at B 8 and B 1 and paged verify's at the speculative and
     chunk shapes, keys a split, CTAs and shared memory a CTA; flash
     decode's instantiation for each q and cache type and its split plan
     at the dense tick, one slot, zamba2-2.7b's and gemma3-1b's shapes;
     flash attention's CUDA-core split plan at the encoder's batches and a
     prefill, RMSNorm's plan (threads a row, vectors a thread) at every
     width the port normalizes; the SSD scan's kernel for each x type,
     each pass's shared memory and its plan at zamba2 prefills of 256,
     768 and 1024 tokens; no register spill in ``paged_decode.cu``
     at D <= 128, nor in ``flash_decode.cu``'s split passes
     (``split_decode.cuh``), nor in flash attention's CUDA-core
     instantiations (every D up to 448), nor in ``rmsnorm.cu``, nor in
     the SSD scan's chunked passes);
  3. each kernel against its plain PyTorch version on the card: paged
     decode and verify with bf16 and int8 pools and bf16 and fp32 queries
     at qwen2-0.5b, gemma3-1b and llama3.2-3b head layouts (decode also
     at the edges of its split kernel: a ragged last split, one slot at
     1024 keys, G 16, D 16, slots at pos 0, free slots among live ones;
     verify also at the CPU tests' cases, T = 4 and T = 64, and a table
     whose last split is ragged); flash attention at the CPU
     tests' cases, the draft's causal prefill at qwen2-0.5b's heads (S 16
     to 1024), gemma3-1b's windowed layers, llama3.2-3b's heads, the
     encoder's non-causal D 448 and zamba2-2.7b's shared attention (32
     heads of 80, S 16 to 768), and the CUDA-core instantiation's edges at
     every head dim (ragged Sq and Sk, one query row, a window, a suffix
     whose rows start below Sk - Sq against a cached prefix); the fused
     RMSNorm at a decode tick, a prefill chunk, the CPU tests' shapes and
     every width the port normalizes (896, 1024, 1152, 256, 3072, 2560,
     5120) at rows 1, 8, 64, 768 and 1024, bf16 and fp32 x and scale,
     zero-centred or not; flash decode over bf16, fp32 and int8 caches
     with bf16 and fp32 queries at the CPU tests' cases, qwen2-0.5b's
     serving shape (B 8, max_seq 1024, contexts 60-1000, a parked slot),
     gemma3-1b's windowed layers, llama3.2-3b's heads, zamba2-2.7b's
     shared attention (B 8, max_seq 1024, D 80) and the reduced configs'
     D 16, and at the edges of its split kernel (a ragged last split, a
     split whose only visible key is its last, one slot at 1024 keys, G 16
     at D 64 and D 80, free slots among live ones with holes); free slots (no visible key) of paged decode, verify
     and flash decode, bf16 and int8, held to the plain version's uniform
     softmax; the grouped matmul in bf16 and fp32 at the CPU tests' cases
     and at granite-moe-1b-a400m's and qwen2-moe-a2.7b's expert shapes
     (decode, verify, chunk and 1024-bucket capacities), C 1, C 17 and a
     split K; the SSD scan,
     y and the final state, in bf16 and fp32, from zeros and from a given
     state, at the CPU tests' sweep, at zamba2-2.7b's width (80 heads
     of 64, state 64) over 1-1024 tokens, and at the edges of the
     chunked kernel's tiles (b 2, 64 chunks, p and n off multiples of 8
     and past one 64-column block);
  4. kernel, plain version and one library call's times at the main
     path's shapes (decode: B 8, B 1 at a 1000-token context, B 8 with
     two free slots; verify: the speculative B 8, T 4, the same with two
     free slots, and the prefill chunk B 1, T 64; the paged kernels and
     SDPA also by their device time alone, the split kernels' by pass;
     paged verify's tensor-core kernel at T = 1 on the decode shape, the
     alternative to paged decode's CUDA-core passes; flash attention:
     the encoder's batch at
     S 256, the draft's prefill buckets and zamba2-2.7b's shared attention
     at S 768; RMSNorm: [8, 896] and [64, 896]; flash decode: the dense
     cache at B 8, max_seq 1024, one slot at a 1000-token context, B 8
     with two free slots and zamba2-2.7b's shared attention (B 8, 32/32
     heads of 80), also by device time per launch; grouped matmul: granite-moe's decode,
     verify, chunk and monolithic capacities and qwen2-moe's decode and
     C 88, against ``torch.bmm``; each flash-attention and grouped-matmul
     row names the instantiation that ran; the SSD
     scan at a zamba2 prefill of 256, 768 and 1024 tokens, also by device
     time and by pass, which no single PyTorch call computes), beside the
     least time the card could take,
     and the kernel held to its plain version there;
  5. the text path: qwen2-0.5b at full width, cut to its first
     MAIN_LAYERS (12) of 24 layers to keep the run's time (random seeded
     bf16 weights; phases 5-9 use this model), serves 12 requests
     through ``ServingEngine`` with a bf16 and an int8 pool; decode
     launches must equal n_layers x decode steps, verify launches
     (chunked-prefill attention) n_layers x prefill chunks, RMSNorm
     launches the norms of every step;
  6. speculation: the same 12 requests with ``spec_k=3``, a bf16 pool
     drafted by the target's own weights and an int8 pool drafted by a
     4-layer cut of the target; verify launches must equal n_layers x
     (verify passes + prefill chunks), flash-attention launches draft
     layers x draft prefills, flash-decode launches draft layers x draft
     decode steps, the self-draft must accept half its drafts or more;
  7. the multimodal path: procedural images (32x32 and 128x128) and audio
     go through the edge encoder (fig11's settings at d 896, fp32) on the
     card, and 12 requests of text head + media span + text tail go
     through the same engine (bf16 pool, int8 pool, bf16 pool with
     speculation); a repeated image must be served from the prefix trie
     and every kernel's launches must equal what the run's steps imply;
  8. the dense backend and monolithic prefill: the same 12 text requests
     through a dense engine with chunked prefill, a dense engine with
     monolithic prefill and paged engines with monolithic prefill (bf16
     and int8 pools, prefix hits through ``prefill_with_prefix``);
     flash-decode launches must equal n_layers x dense decode steps,
     flash-attention launches n_layers x monolithic prefills; the streams
     of the dense and paged runs are compared and printed (bf16 near-ties
     may differ);
  9. a window of PROFILE_STEPS engine steps of the bf16 text path, and
     one of phase 8's dense chunked engine, each run once plainly and once
     under ``torch.profiler`` with the engine's trace spans: device busy
     share, engine-span totals, top kernels by device time, and the device
     time and launches of paged decode's, paged verify's, flash decode's,
     flash attention's, RMSNorm's and the SSD scan's kernels;
  9b. the MoE path: granite-moe-1b-a400m at full width and depth (random
     seeded bf16 weights) serves the 12 text requests through paged
     chunked engines (bf16 and int8 pools), a paged monolithic engine, a
     dense chunked engine and a paged engine with spec_k=3 and a 4-layer
     MoE draft; grouped-matmul launches must equal 3 x n_layers x (decode
     steps + prefill chunks + monolithic prefills + verify passes) + 3 x
     draft layers x (draft prefills + draft steps), the other kernels' as
     in phases 5-8;
  9c. the hybrid path: zamba2-2.7b at full width and depth (54 Mamba2
     layers in 9 groups of 6, one shared attention+MLP block, 2.44 B
     parameters drawn on the card from seed 0 in bf16) serves 12 text
     requests of 1-768 tokens through ``ServingEngine`` on the dense
     backend with exact-shape monolithic prefill; ssd_scan launches must
     equal 54 x prefills, flash attention 9 x prefills, flash decode 9 x
     decode steps, RMSNorm the norms of every prefill and step; a
     300-token prompt is refused with the prompt-length ValueError; then
     one monolithic prefill of the 768-token prompt under
     ``torch.profiler``: device busy time, the SSD scan's device time,
     launches and share of it;
  9d. the continuum: fig10's fleet (benchmarks/fig10_continuum_replay.py)
     at full width and depth on the card, one cloud llama3.2-3b (28
     layers, bf16 pool) and two edge qwen2-0.5b (24 layers, int8 pools),
     seeded weights drawn on the card, the handles' own settings
     (max_batch 2, max_seq 96, page 16, prefill_chunk 64), through
     ``serving/cluster.py``; fig10's smoke budget (32 users of
     ``generate(0, 200)``, an arrival every 0.01 virtual s) replayed under
     all-cloud, greedy and fig10's QLMIO rule (a numpy copy) at quality
     weight 1.0: every request gets its full budget, QLMIO's mean e2e is
     below all-cloud's at a completion rate >= 0.95 x its, each policy's
     decisions equal its decisions under the cost-model backend, and each
     kernel's launches equal what the fleet's steps imply; then two
     full-width qwen2-0.5b handles sharing weights migrate a decoding
     request (``Cluster.migrate`` after 3 tokens) bf16 -> bf16 and
     int8 -> int8 with chunked and monolithic prefill (the single-engine
     run's tokens, no prefill on the destination, page counters and bytes
     = pages x page_bytes()), and bf16 -> int8 and int8 -> bf16 (full
     budget, agreement with the unmigrated stream printed);
  10. reduced qwen2-0.5b, gemma3-1b, granite-moe-1b-a400m and
     qwen2-moe-a2.7b in fp32, and granite-moe with capacity_factor 0.3
     and 16 slots (experts overflow beside free slots), text and
     multimodal requests: the engine on the CPU (plain versions) and on
     the card (kernels) give identical tokens, speculative, dense
     (chunked and monolithic) and paged monolithic engines included
     (every variant for the dense configs; for the MoE configs each
     variant once: granite-moe bf16 plain, speculative and monolithic,
     qwen2-moe bf16 plain and speculative, the overflowing one the
     variants whose kernels see free slots), and for the dense configs
     speculation on the card gives the tokens of plain decode (an MoE
     layer's drops depend on how a call batches its tokens, so there it is
     printed); the reduced encoder on the card gives the CPU's features;
     reduced zamba2-2.7b in fp32 with scan_chunk 16 (text prompts of 1-64
     tokens, several chunks) on the dense backend with monolithic
     prefill gives the CPU engine's tokens on the card;
 11. one JSON line for the kernels (each with its device time and the
     library call's at its phase-4 shape beside the contract's keys), then
     the result line.

Needs a CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository's
``src`` directory beside this file.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.baselines import (all_cloud_policy,  # noqa: E402
                                        greedy_policy)
from repro_torch.data.taskgen import CATEGORIES, make_taskset  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention, moe_gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import paged_decode, paged_verify  # noqa: E402
from repro_torch.kernels import flash_decode  # noqa: E402
from repro_torch.kernels import ssd_scan as scan_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode_quant_ref, flash_decode_ref)
from repro_torch.kernels.moe_gmm import grouped_matmul_ref  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    paged_decode_quant_ref, paged_decode_ref)
from repro_torch.kernels.paged_verify import (  # noqa: E402
    paged_verify_quant_ref, paged_verify_ref)
from repro_torch.kernels.quant import quantize_kv  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mm_encoder as enc  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving.cluster import (CLASS_ARCHS,  # noqa: E402
                                        Cluster, EngineBackend,
                                        EngineHandle,
                                        build_continuum)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.request import ContinuumRequest  # noqa: E402
from repro_torch.serving.segments import (EmbedSegment,  # noqa: E402
                                          TextSegment)
from repro_torch.serving.telemetry import Telemetry  # noqa: E402
from repro_torch.sim import cost_model as cm  # noqa: E402
from repro_torch.sim.cemllm import (make_servers_from_spec,  # noqa: E402
                                    run_policy)
from repro_torch.sim.miobench import SERVER_CLASSES, generate  # noqa: E402

# H100 SXM, NVIDIA's data sheet (dense): HBM rate and peak operation rates
# (bf16: the tensor cores, on which flash attention and the grouped matmul
# multiply bf16; fp32: 67 TFLOP/s outside the tensor cores, the rate of
# the fp32 CUDA-core products of every kernel, TF32 never used)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12,
                  torch.float32: 67e12}
# Kernel vs plain version; every kernel output is held twice.
# 1. Against the plain version on the same values widened to fp32 (fp32 q,
#    fp32 pages, or the same int8 pages and scales): the two then differ
#    only in summation order (online vs two-pass softmax) and in the
#    kernel's rounding of its fp32 result to q's type, at most half a bf16
#    ulp (2^-8 relative).  So one bf16 ulp (2^-7) relative for a bf16
#    output, 1e-4 relative for fp32, plus 1e-5 absolute for outputs near 0.
#    The rows compared have an RMS of 0.04-1; a dropped key, a mask off by
#    one or a missed block moves them by far more than this.
EXACT_TOL = {torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7),
             torch.float32: dict(atol=1e-5, rtol=1e-4)}
#    The attention kernels over bf16 pages or caches (ROUNDED) round each
#    probability to bf16 before the value product, as the plain version
#    does on bf16 values and does not on the widened ones: each is off by
#    at most half a bf16 ulp (2^-8 relative), a bf16 result by another
#    2^-8, so they are held within 2^-7 of the plain version on |v| (the
#    probability-weighted sum of |v|), plus 1e-5 (ROUNDED_TOL).
ROUNDED_TOL = dict(atol=1e-5, rtol=2 ** -7)
# 2. Against the plain version on the same inputs in the working type (bf16
#    q, and for ROUNDED also fp32 q), with the tolerances of
#    test_kv_cache.py:137 (both round the probabilities to bf16 before the
#    value product, from fp32 values that differ in their last bits, so
#    either may round one the other way) and test_kv_quant.py:85 (int8:
#    both dequantize to the same fp32 values); flash attention and RMSNorm
#    with test_kernels.py's _tol for bf16 (both round the same fp32 result
#    to bf16).  max_abs_err in the kernels line is this error.
TOL = {"paged_decode": dict(atol=5e-2, rtol=5e-2),
       "paged_decode_quant": dict(atol=5e-3, rtol=5e-3),
       "paged_verify": dict(atol=5e-2, rtol=5e-2),
       "paged_verify_quant": dict(atol=5e-3, rtol=5e-3),
       "flash_attention": dict(atol=5e-2, rtol=5e-2),
       "rmsnorm": dict(atol=5e-2, rtol=5e-2),
       "flash_decode": dict(atol=5e-2, rtol=5e-2),
       "flash_decode_quant": dict(atol=5e-3, rtol=5e-3),
       "grouped_matmul": dict(atol=1e-2, rtol=5e-2)}
# 3. The grouped matmul sums up to 2048 products of unit normals in fp32 in
#    another order than the plain version's einsum: 1e-3 absolute on top
#    of EXACT_TOL's relative part (outputs of magnitude ~30-45), and
#    test_kernels.py's 1e-2 / 5e-2 in bf16 (TOL above).
GMM_EXACT_TOL = {torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7),
                 torch.float32: dict(atol=1e-3, rtol=1e-4)}
# 4. The SSD scan (y and the final state, both fp32) against its plain
#    version on the same inputs, which computes in fp32 as the kernel does
#    (bf16 x, B and C are the same numbers to both): the same products
#    summed in other orders, over up to 256 keys per chunk and a state
#    carried across up to 4 chunks, so 1e-4 relative plus 1e-4 of the
#    compared tensor's RMS (SCAN_TOL); a wrong mask, decay or chunk
#    boundary moves outputs by far more.  max_abs_err is this error.
SCAN_TOL = dict(atol_rms=1e-4, rtol=1e-4)
# 5. A row with no visible key (a free slot) gets the plain version's
#    uniform softmax over every key it reads: the same weighted value rows
#    summed in another order, so EXACT_TOL's parts scale the plain version
#    on |v| instead of the output (poisoned scales make these rows ~1e8).
# the wrappers that round probabilities where the pages or caches are bf16
ROUNDED = ("paged_decode", "paged_verify", "flash_decode")
SOURCES = {"paged_decode": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "paged_verify": "src/repro_torch/kernels/csrc/paged_verify.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "moe_gmm": "src/repro_torch/kernels/csrc/moe_gmm.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
# the source of each kernel whose name is not its source's
SOURCE_OF = {"grouped_matmul": "moe_gmm"}
REPLACES = {"paged_decode": "src/repro/kernels/paged_decode.py:92",
            "paged_decode_quant": "src/repro/kernels/paged_decode.py:137",
            "paged_verify": "src/repro/kernels/paged_verify.py:95",
            "paged_verify_quant": "src/repro/kernels/paged_verify.py:147",
            "flash_attention": "src/repro/kernels/flash_attention.py:84",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:23",
            "flash_decode": "src/repro/kernels/flash_decode.py:71",
            "flash_decode_quant": "src/repro/kernels/flash_decode.py:125",
            "grouped_matmul": "src/repro/kernels/moe_gmm.py:38",
            "ssd_scan": "src/repro/kernels/mamba2_scan.py:60"}
WRAPPERS = {"paged_decode": ops.paged_decode,
            "paged_decode_quant": ops.paged_decode_quant,
            "paged_verify": ops.paged_verify,
            "paged_verify_quant": ops.paged_verify_quant,
            "flash_attention": ops.flash_attention,
            "rmsnorm": ops.rmsnorm,
            "flash_decode": ops.flash_decode,
            "flash_decode_quant": ops.flash_decode_quant,
            "grouped_matmul": ops.grouped_matmul,
            "ssd_scan": ops.ssd_scan}
PLAINS = {"paged_decode": paged_decode_ref,
          "paged_decode_quant": paged_decode_quant_ref,
          "paged_verify": paged_verify_ref,
          "paged_verify_quant": paged_verify_quant_ref,
          "flash_attention": flash_attention_ref,
          "rmsnorm": rmsnorm_ref,
          "flash_decode": flash_decode_ref,
          "flash_decode_quant": flash_decode_quant_ref,
          "grouped_matmul": grouped_matmul_ref,
          "ssd_scan": ssd_scan_ref}
SPEC_K = 3
# the layers of qwen2-0.5b (24) that phases 5-9 run: cut from 24 to 12
# to make room for the MoE phases within the run's time
MAIN_LAYERS = 12
# the MoE path (phase 9b): granite-moe-1b-a400m at full width, served with
# a 4-layer cut of itself as the speculative draft
MOE_ARCH = "granite-moe-1b-a400m"
MOE_DRAFT_LAYERS = 4
# the hybrid path (phase 9c): zamba2-2.7b at full width and depth
HYBRID_ARCH = "zamba2-2.7b"
# the continuum (phase 9d): fig10's spec (one cloud llama3.2-3b, two edge
# qwen2-0.5b) and smoke budget (benchmarks/fig10_continuum_replay.py:43-52):
# 32 users of generate(seed=0, n_tasks=200), an arrival every 0.01 virtual s
CONTINUUM_SPEC = [(2, 1), (1, 1), (0, 1)]
CONTINUUM_TASKS = 200
CONTINUUM_USERS = 32
CONTINUUM_ARRIVAL_DT = 0.01
# decode tokens a request has before Cluster.migrate moves it (phase 9d)
MIGRATE_AFTER = 3
# the edge encoder of the multimodal path: fig11's settings at qwen2-0.5b's
# width (benchmarks/fig11_multimodal_split.py:78), fp32, seeded params
ENC_CFG = enc.MMEncoderConfig(d_model=896, img_size=32, patch=8,
                              audio_dim=16, keep_ratio=1 / 3)
ENC_SEED = 17
AUDIO_FRAMES = 24
# the model layouts the kernels are held at: (arch, H, Hkv, D, window)
WIDTHS = [("qwen2-0.5b", 14, 2, 64, 0), ("gemma3-1b", 4, 1, 256, 512),
          ("llama3.2-3b", 24, 8, 128, 0)]
# paged decode's split kernel at its edges (phase 3): (label, B, H, Hkv, D,
# NB, window, contexts, free slots), page 16: the last split ragged (1040
# keys in 17 splits of 64), one slot of a lightly loaded server, G 16, the
# reduced configs' D 16, slots at pos 0 (one visible key), free slots
# among live ones
DECODE_EDGES = [
    ("ragged last split", 3, 14, 2, 64, 65, 0, [1040, 700, 33], ()),
    ("B 1 at 1024 keys", 1, 14, 2, 64, 64, 0, [1000], ()),
    ("G 16", 2, 16, 1, 64, 64, 0, [1024, 300], ()),
    ("D 16", 3, 4, 2, 16, 9, 0, [144, 50, 1], ()),
    ("pos 0", 4, 14, 2, 64, 64, 0, [1, 800, 1, 64], ()),
    ("free slots among live", 8, 14, 2, 64, 64, 0,
     [60, 150, 290, 400, 520, 640, 760, 1000], (1, 4, 6))]
# the profiled window of the main path: engine steps SKIP .. SKIP + STEPS
PROFILE_SKIP, PROFILE_STEPS = 30, 10
# flash attention held to its plain version: (B, Sq, Sk, H, Hkv, D, causal,
# window), the CPU tests' cases (tests/test_torch_multimodal.py
# FLASH_CASES: test_kernels.py's sweep and a non-causal D 448), the draft's
# causal prefill at qwen2-0.5b heads over prompt buckets 16-1024,
# gemma3-1b's windowed local layers, llama3.2-3b heads, the encoder
# (non-causal, two heads of 448) at S 16 and 256, and the reduced configs'
# D 16
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0), (1, 128, 128, 4, 4, 32, True, 48),
    (2, 64, 192, 2, 1, 64, True, 0), (2, 96, 160, 2, 2, 64, False, 0),
    (1, 100, 100, 4, 2, 32, True, 0), (2, 40, 40, 2, 2, 448, False, 0),
    (1, 16, 16, 14, 2, 64, True, 0), (1, 64, 64, 14, 2, 64, True, 0),
    (1, 256, 256, 14, 2, 64, True, 0), (1, 1024, 1024, 14, 2, 64, True, 0),
    (1, 1024, 1024, 4, 1, 256, True, 512),
    (2, 600, 600, 4, 1, 256, True, 512),
    (1, 512, 512, 24, 8, 128, True, 0),
    (4, 16, 16, 2, 2, 448, False, 0), (4, 256, 256, 2, 2, 448, False, 0),
    (2, 48, 48, 4, 2, 16, True, 0)]
# zamba2-2.7b's shared attention: 32 heads of 80, causal prompts of 16-768
FLASH_CASES += [(1, S, S, 32, 32, 80, True, 0) for S in (16, 200, 512, 768)]
# the CUDA-core (fp32) instantiation's edges at every head dim: ragged Sq =
# Sk, one query row, a window, a ragged non-causal Sk
FLASH_CASES += [case for D in flash_attention.HEAD_DIMS
                for case in ((2, 130, 130, 4, 2, D, True, 0),
                             (1, 1, 77, 4, 4, D, True, 0),
                             (1, 100, 100, 4, 1, D, True, 40),
                             (3, 37, 300, 2, 2, D, False, 0))]
# ... and a suffix against a cached prefix whose query rows start below
# Sk - Sq (q_offset 40 of Sk 150, Sq 70), with and without a window:
# (B, Sq, Sk, H, Hkv, D, window, q_offset), causal
FLASH_OFFSET_CASES = [(2, 70, 150, 4, 2, D, window, 40)
                      for D in flash_attention.HEAD_DIMS
                      for window in (0, 24)]
# flash attention's CUDA-core split plan printed in phase 2: (label, B, S,
# H)
FLASH_PLANS = [("encoder 128x128 batch", 4, 256, 2),
               ("encoder 32x32 batch", 4, 16, 2),
               ("one 128x128 image", 1, 256, 2),
               ("qwen2-0.5b 1024-token prefill (fp32 parity runs)", 1, 1024,
                14)]
# RMSNorm held to its plain version: a decode tick and a prefill chunk of
# qwen2-0.5b, test_kernels.py::test_rmsnorm's shapes, then zamba2-2.7b's
# norms at d 2560 (pre-norm, shared ln2, final) and d_inner / 2d 5120
# (gated norm, shared ln1 on concat(x, x0)) at a decode tick of 8 slots,
# a 1-token prompt and a 768-token prompt
RMS_SHAPES = [(8, 896), (64, 896), (3, 50, 96), (7, 128), (260, 64)]
RMS_SHAPES += [(8, 2560), (8, 5120), (1, 5120), (768, 2560), (768, 5120)]
# ... and every other width the port normalizes at rows 1, 8, 64 and 1024:
# the encoder's 1024 rows of 896 (in fp32 a row's 224 vectors over 64
# threads, the last 32 holding 3 of their 4), granite-moe 1024, gemma3-1b
# 1152 and its qk-norm's 256 (tokens x heads), llama3.2-3b 3072
RMS_SHAPES += [(1, 896), (1024, 896), (8, 1024), (64, 1024), (8, 1152),
               (7, 4, 256), (64, 256), (8, 3072), (1, 3072)]
# flash decode held to its plain version: (B, S, H, Hkv, D, window,
# engine[, dense_case keywords]), test_kernels.py::test_flash_decode's
# cases (full caches), then caches as the engines leave them (``engine``:
# -1 past each context, the query up to 3 positions before the last entry,
# a parked slot at pos = S): qwen2-0.5b's serving shape, gemma3-1b's
# windowed local layers, llama3.2-3b's heads, the reduced configs' D 16 and
# zamba2-2.7b's shared attention (B 8, max_seq 1024, 32 heads of 80); then
# the edges of the split kernel: a ragged last split (1000 keys, 16 splits
# of 64), a split whose only visible key is its last, one slot at 1024
# keys, G 16 at D 64 and at D 80, free slots among live ones with holes
# inside the contexts
DECODE_CASES = [
    (2, 96, 8, 2, 64, 0, False), (2, 128, 4, 4, 32, 24, False),
    (1, 70, 8, 1, 64, 0, False), (8, 1024, 14, 2, 64, 0, True),
    (2, 1024, 4, 1, 256, 512, True), (4, 512, 24, 8, 128, 0, True),
    (3, 64, 4, 2, 16, 0, True), (8, 1024, 32, 32, 80, 0, True),
    (3, 1000, 14, 2, 64, 0, True),
    (2, 1024, 14, 2, 64, 0, True, dict(ctx=[1024, 700],
                                       last_only=(0, 128, 192))),
    (1, 1024, 14, 2, 64, 0, True, dict(ctx=[1000])),
    (2, 1024, 16, 1, 64, 0, True), (2, 1024, 16, 1, 80, 0, True),
    (8, 1024, 14, 2, 64, 0, True, dict(free=(2, 5, 6), holes=8))]
# flash decode's split plan at the shapes the serving paths give it (phase
# 2): (label, B, H, Hkv, D), max_seq 1024
FLASH_DECODE_PLANS = [("qwen2-0.5b dense tick and draft", 8, 14, 2, 64),
                      ("qwen2-0.5b, one slot", 1, 14, 2, 64),
                      ("zamba2-2.7b shared attention", 8, 32, 32, 80),
                      ("gemma3-1b local layers", 8, 4, 1, 256)]
# phase 10's engine variants: (label, engine keywords, speculative)
VARIANTS = {"bf16": ({}, False), "bf16 spec": ({}, True),
            "int8": (dict(kv_dtype="int8"), False),
            "int8 spec": (dict(kv_dtype="int8"), True),
            "dense chunked": (dict(paged=False), False),
            "dense monolithic": (dict(paged=False, prefill_chunk=0), False),
            "paged bf16 monolithic": (dict(prefill_chunk=0), False),
            "paged int8 monolithic": (dict(prefill_chunk=0, kv_dtype="int8"),
                                      False)}
# phase 10's configs: (arch, overrides of the reduced config, max_batch,
# the variants it serves).  The dense configs serve every variant.  The
# MoE configs share the engine's paths with them, so each MoE variant is
# served once: granite-moe the bf16 pool plain and speculative and paged
# monolithic prefill (whole-prompt buckets through the experts);
# qwen2-moe, whose own code is the shared expert, the bf16 pool plain and
# speculative; granite-moe with its capacity factor lowered so that
# experts overflow, with 16 slots (16 decode tokens, 8 an expert on
# average, against a capacity of 8) of which some are free while others
# decode, the variants whose kernels see free slots: paged decode (bf16
# and int8), verify, and dense decode
PARITY = [("qwen2-0.5b", {}, 3, tuple(VARIANTS)),
          ("gemma3-1b", {}, 3, tuple(VARIANTS)),
          ("granite-moe-1b-a400m", {}, 3,
           ("bf16", "bf16 spec", "paged bf16 monolithic")),
          ("qwen2-moe-a2.7b", {}, 3, ("bf16", "bf16 spec")),
          ("granite-moe-1b-a400m", dict(capacity_factor=0.3), 16,
           ("bf16", "bf16 spec", "int8", "dense chunked"))]
# the dense cache's contexts at the main path's decode shape
DENSE_CTX = np.asarray([60, 150, 290, 400, 520, 640, 760, 1000])
# the grouped matmul held to its plain version: (label, E, C, K, N), the
# CPU tests' cases (test_kernels.py::test_grouped_matmul's sweep), then
# granite-moe-1b-a400m's experts (E 32, d 1024, ff 512: gate/up K 1024 N
# 512, down K 512 N 1024) at the capacities of a decode tick (8 tokens),
# a verify pass (8 x 4), a 64-token chunk and a 1024-token bucket, and
# qwen2-moe-a2.7b's (E 60, d 2048, ff 1408) at a decode tick and a
# 1024-token bucket
GMM_CASES = [("sweep", 4, 48, 96, 40), ("sweep", 8, 16, 64, 128),
             ("sweep", 2, 130, 70, 90)]
GMM_CASES += [(f"granite {what} C {C}", 32, C, K, N)
              for C in (8, 16, 24, 320)
              for what, K, N in (("gate/up", 1024, 512), ("down", 512, 1024))]
GMM_CASES += [(f"qwen2-moe {what} C {C}", 60, C, K, N) for C in (8, 88)
              for what, K, N in (("gate/up", 2048, 1408),
                                 ("down", 1408, 2048))]
# the edges of the bf16 instantiations: one token (the small-C tile; at E
# 4 its grid has fewer CTAs than the card has SMs, so K is split), one
# past the small-C tile (C 17, the chunk tile) and an unaligned K through
# the small-C tile's scalar staging
GMM_CASES += [("C 1", 4, 1, 512, 256), ("C 17", 4, 17, 512, 256),
              ("unaligned K", 3, 5, 70, 64)]
# the SSD scan held to its plain version: (b, S, h, p, n, chunk), the CPU
# tests' sweep (test_kernels.py::test_ssd_scan), then zamba2-2.7b's width
# (80 heads of 64, state 64) over prompts of 1 token (a chunk of 1, as
# phase 9c serves), 37, 48, 200, 256 (one chunk), 512, 768 and 1024 tokens
# (2, 3 and 4 chunks of 256); then the edges of the chunked kernel's
# tiles: b 2, 64 chunks of state passing (chunk 16 over 1024 tokens), p
# and n that are not multiples of 8, p past one 64-column block and n
# past two
SCAN_CASES = [(b, S, h, p, n, c) for b, S, h, p, n in
              ((2, 64, 4, 16, 8), (1, 128, 2, 32, 16)) for c in (16, 32, 64)]
SCAN_CASES += [(1, S, 80, 64, 64, 256)
               for S in (1, 37, 48, 200, 256, 512, 768, 1024)]
SCAN_CASES += [(2, 512, 80, 64, 64, 256), (1, 1024, 80, 64, 64, 16),
               (1, 48, 3, 24, 12, 16), (1, 256, 4, 128, 136, 64)]


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def dev_us(e) -> float:
    """A profiler event's own device time in microseconds (the attribute's
    name differs across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return getattr(e, name)
    return 0


def device_ms(fn, calls: int = 20, by_kernel: "dict | None" = None
              ) -> float:
    """Mean device time per call of ``fn(i)``: the kernels it launches as
    ``torch.profiler`` records them, without the host's time between
    launches (which sets ``cuda_ms`` of a call whose kernels are short).
    The window is profiled three times and the fullest reading kept: on
    the card's host a session now and then records none or only some of
    the window's kernels (an SDPA call read 0.0009 ms of its usual 0.022
    once, and whole windows came back empty), and a lost kernel can only
    lower a reading.  ``by_kernel``, if given,
    receives that reading's kernels (name -> ms a call)."""
    fn(0)
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    best_us, best = 0.0, []
    for _ in range(3):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == cuda
                  and dev_us(e) > 0]
        us = sum(dev_us(e) for e in events)
        if us > best_us:
            best_us, best = us, events
    check(best_us > 0, "the profiler saw no device time")
    if by_kernel is not None:
        by_kernel.update({e.key: dev_us(e) / calls / 1e3 for e in best})
    return best_us / calls / 1e3


def paged_case(rng, B, H, Hkv, D, bs, NB, ctx, *, T=0, layers=1,
               inactive=()):
    """Random pools [layers, P, bs, Hkv, D] (fp32, on the card), a block
    table with -1 tails covering each slot's context, and q [B, H, D] at
    positions ctx - 1 or, with T, q [B, T, H, D] whose first token sits
    at ctx - T (the last one at ctx - 1); slots in ``inactive`` get an all
    -1 row and position 0."""
    P = 1 + B * NB
    dev = torch.device("cuda")
    shape = (B, T, H, D) if T else (B, H, D)
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k = torch.randn(layers, P, bs, Hkv, D, device=dev)
    v = torch.randn(layers, P, bs, Hkv, D, device=dev)
    bt = np.full((B, NB), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b, n in enumerate(ctx):
        if b in inactive:
            continue
        nb = -(-int(n) // bs)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
    pos = np.asarray([0 if b in inactive else n - max(T, 1)
                      for b, n in enumerate(ctx)], np.int32)
    return (q.to(dev), k, v, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev))


def within(a, w, tol) -> bool:
    return bool(((a - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())


def hold_dead(name, out, args, kw, dead, where) -> float:
    """Holds an attention kernel's rows with no visible key (``dead``:
    slots or a [B, T] mask) to its plain version on the same inputs, the
    uniform softmax over every key it reads, within EXACT_TOL's parts of
    the plain version on |v| (args[2]; see 4. above); returns the largest
    error over that scale."""
    plain = PLAINS[name]
    want = plain(*args, **kw).float()[dead]
    absargs = list(args)
    absargs[2] = args[2].abs()
    scale = plain(*absargs, **kw).float()[dead]
    tol = EXACT_TOL[out.dtype]
    err = (out.float()[dead] - want).abs()
    check(bool((err <= tol["atol"] + tol["rtol"] * scale).all()),
          f"{name} {where}: rows with no visible key differ from the plain "
          f"version by up to {float(err.max())}")
    check(bool((want != 0).any()), f"{name} {where}: plain dead rows zero")
    return float((err / scale.clamp(min=1e-30)).max())


def hold(name, out, args, kw, rows, where, dead=None) -> tuple:
    """Holds one kernel output (rows ``rows``: slots, a [B, T] mask, or
    ``slice(None)``) to its plain version, called with ``args`` and the
    keywords ``kw``, both ways (see EXACT_TOL, ROUNDED_TOL, TOL), and the
    rows ``dead`` with no visible key through ``hold_dead``; returns the
    largest error against the fp32 plain version and in the working type
    (0.0 for an fp32 query or x, except for the kernels that round
    probabilities)."""
    if dead is not None:
        hold_dead(name, out, args, kw, dead, where)
    q = args[0]
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"{name} {where}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()),
          f"{name} {where}: non-finite output")
    plain = PLAINS[name]
    rounded = name in ROUNDED and args[2].dtype == torch.bfloat16
    a = out.float()[rows]
    wide = [t.float() if t.is_floating_point() and t.dtype != torch.float32
            else t for t in args]
    exact = plain(*wide, **kw).float()[rows]
    err32 = float((a - exact).abs().max())
    if rounded:
        wide[2] = wide[2].abs()
        scale = plain(*wide, **kw).float()[rows]
        tol = ROUNDED_TOL
        ok = bool(((a - exact).abs()
                   <= tol["atol"] + tol["rtol"] * scale).all())
    else:
        tol = EXACT_TOL[out.dtype]
        ok = within(a, exact, tol)
    check(ok, f"{name} {where}: max |err| {err32} vs the fp32 plain "
          f"version, over tolerance {tol}")
    if q.dtype == torch.float32 and not rounded:
        return err32, 0.0
    want = plain(*args, **kw).float()[rows]
    err = float((a - want).abs().max())
    check(within(a, want, TOL[name]), f"{name} {where}: max |err| {err} vs "
          f"the plain version, over tolerance {TOL[name]}")
    return err32, err


def quantized(k, v):
    """[L, P, ...] pools -> int8 pools + fp32 scales, with the null page
    of every layer poisoned."""
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    ks[:, 0] = 1e6
    vs[:, 0] = 1e6
    return k8, v8, ks, vs


def dense_case(rng, B, S, H, Hkv, D, engine, *, layers=0, ctx=None,
               free=None, holes=0, last_only=None):
    """Random dense caches [B, S, Hkv, D] (fp32, on the card; with
    ``layers``, [layers, B, S, Hkv, D]), cache_positions [B, S] int32 and
    q [B, H, D] at pos [B].  Without ``engine``: every entry holds its
    index and pos lies in [S/2, S) (test_kernels.py).  With it: slot b
    holds ``ctx[b]`` entries (random if None), -1 past them and ``holes``
    empty entries inside, the query sits up to 3 positions before the last
    entry (stale entries past it, as a rejected draft chain leaves them),
    for B > 2 the last slot is parked at pos = S and the slots ``free``
    (by default, for B > 3 with random contexts, the one before the last)
    are free (all -1, pos 0: they see no key).  ``last_only`` = (b, k0,
    k1): keys k0 .. k1 - 2 of slot b are emptied (the split's only visible
    key is its last).  Returns (q, k, v, cpos, pos, rows): ``rows`` the
    slots that see a key."""
    dev = torch.device("cuda")
    lead = (layers,) if layers else ()
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k = torch.randn(lead + (B, S, Hkv, D), device=dev)
    v = torch.randn(lead + (B, S, Hkv, D), device=dev)
    cpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if not engine:
        pos = rng.integers(S // 2, S, B).astype(np.int32)
    else:
        if free is None:
            free = (B - 2,) if B > 3 and ctx is None else ()
        if ctx is None:
            ctx = rng.integers(S // 8, S + 1, B)
        pos = np.zeros(B, np.int32)
        for b, n in enumerate(ctx):
            cpos[b, n:] = -1
            if holes:
                cpos[b, rng.choice(n, size=holes, replace=False)] = -1
            pos[b] = max(n - 1 - int(rng.integers(0, 4)), 0)
        if last_only is not None:
            b, k0, k1 = last_only
            cpos[b, k0:k1 - 1] = -1
            cpos[b, k1 - 1] = k1 - 1
        if B > 2:
            pos[-1] = S
        for b in free:
            cpos[b], pos[b] = -1, 0
    rows = [b for b in range(B) if ((cpos[b] >= 0) & (cpos[b] <= pos[b]))
            .any()]
    return (q.to(dev), k, v, torch.from_numpy(cpos).to(dev),
            torch.from_numpy(pos).to(dev), rows)


def dense_quantized(k, v, cpos):
    """Dense caches -> int8 caches + fp32 row scales, with the scales of
    every empty entry poisoned (``cpos`` [B, S, 1] -1): they must never
    be read."""
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    empty = (cpos < 0).expand(ks.shape)
    ks[empty] = 1e6
    vs[empty] = 1e6
    return k8, v8, ks, vs


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: this run needs a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}; count {torch.cuda.device_count()}")
    print(smi)
    return smi


def cuda_tool(name: str) -> "str | None":
    """A CUDA toolkit binary on the PATH or under /usr/local/cuda/bin."""
    tool = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return tool if Path(tool).exists() else None


def hmma_count(path) -> "int | None":
    """HMMA (tensor-core) instructions in a built library's SASS, or None
    where ``cuobjdump`` is not installed."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return sass.count("HMMA")


def kernel_names(mangled: list) -> list:
    """ptxas entry names as ``name<template arguments>`` where
    ``cu++filt`` demangles them (one call for all), else as ptxas prints
    them."""
    tool = cuda_tool("cu++filt")
    if tool is None or not mangled:
        return mangled
    names = subprocess.run([tool, *mangled], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    if len(names) != len(mangled):
        return mangled
    out = []
    for name in names:
        for noise in ("void ", "<unnamed>::", "(anonymous namespace)::"):
            name = name.replace(noise, "")
        out.append(name.split("(", 1)[0])
    return out


def ptxas_spills(ptxas: str) -> list:
    """(entry, head dim or None, spill bytes stored and loaded) of each
    kernel in ``nvcc -Xptxas -v`` output; the head dim is the first integer
    template argument of the mangled name (``Li64E``)."""
    out, entry = [], None
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                   line))
            dim = re.search(r"Li(\d+)E", entry)
            out.append((entry, int(dim.group(1)) if dim else None, spill))
            entry = None
    return out


def phase_build():
    """Every source at once, one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name, info in infos.items():
        build.load(name)
        hmma = hmma_count(info["path"])
        print(f"[build] {name}.cu -> sm_90a in {info['seconds']:.2f} s"
              f"{'' if info['built'] else ' (already built)'}; "
              + ("cuobjdump not found" if hmma is None
                 else f"{hmma} HMMA instructions in its SASS"))
        lines = info["ptxas"].splitlines()
        names = iter(kernel_names([line.split("'")[1] for line in lines
                                   if "Compiling entry" in line]))
        for line in lines:
            if "Compiling entry" in line:
                print("[build]   " + next(names))
            elif "Used" in line or "spill" in line or "smem" in line:
                print("[build]     " + line.strip())
    for dt in (torch.bfloat16, torch.float32):
        print(f"[build]   flash attention {str(dt)[6:]}: " + "; ".join(
            f"D {D}: {flash_attention.variant(D, dt)}, "
            f"{flash_attention.tile_rows(D, dt)} query rows and "
            f"{flash_attention.smem_bytes(D, dt)} bytes of dynamic shared "
            "memory per CTA" for D in flash_attention.HEAD_DIMS))
    for label, B, S, H in FLASH_PLANS:
        splits = flash_attention.plan(B, S, S, H)
        tiles = -(-S // flash_attention.tile_rows(448, torch.float32))
        print(f"[build]   flash attention, CUDA-core plan, {label} (B {B}, S "
              f"{S}, {H} heads): {splits} splits of the key tiles a cluster, "
              f"{splits * tiles * H * B} CTAs")
    spills = [(name, D, n) for name, D, n
              in ptxas_spills(infos["flash_attention"]["ptxas"])
              if "flash_fp32" in name]
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills if n]
    check(not spilled, "flash_attention.cu: register spills of the CUDA-core "
          "instantiations: " + ", ".join(spilled))
    print("[build]   flash attention: " + (
        f"{len(spills)} CUDA-core instantiations (D up to 448), none spills"
        if spills else "already built, ptxas not rerun"))
    print("[build]   rmsnorm plan (vectors a thread, threads a row): " +
          "; ".join(f"[{rows}, {d}] {str(dt)[6:]} "
                    f"{rms_kernel.plan(rows, d, dt)}"
                    for rows, d in ((8, 896), (64, 896), (1024, 896),
                                    (8, 1024), (8, 1152), (56, 256),
                                    (8, 3072), (8, 2560), (768, 5120))
                    for dt in (torch.bfloat16, torch.float32)))
    spills = ptxas_spills(infos["rmsnorm"]["ptxas"])
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills if n]
    check(not spilled, "rmsnorm.cu: register spills: " + ", ".join(spilled))
    print("[build]   rmsnorm: " + (
        f"{len(spills)} instantiations, none spills" if spills
        else "already built, ptxas not rerun"))
    print("[build]   grouped matmul: " + "; ".join(
        f"{str(dt)[6:]} C {C}: {moe_gmm.variant(dt, C)}"
        for dt in (torch.bfloat16, torch.float32) for C in (8, 16, 24, 320)))
    print("[build]   flash decode: " + "; ".join(
        f"{str(q)[6:]} q, {str(c)[6:]} cache: {flash_decode.variant(q, c)}"
        for q, c in itertools.product((torch.bfloat16, torch.float32),
                                      flash_decode.CACHE_DTYPES)))
    for label, B, H, Hkv, D in FLASH_DECODE_PLANS:
        p = flash_decode.plan(B, H // Hkv, Hkv, 1024, D)
        smem = [flash_decode.smem_bytes(H // Hkv, D, p.split_keys, p.splits,
                                        dt)
                for dt in (torch.bfloat16, torch.int8)]
        print(f"[build]   flash decode, {label} (B {B}, heads {H}/{Hkv}, D "
              f"{D}, S 1024), bf16 q: {p.split_keys} keys a split "
              f"({p.splits} splits), {p.ctas} CTAs a launch, {smem[0]} (bf16 "
              f"cache) and {smem[1]} (int8) bytes of dynamic shared memory a "
              "CTA")
    print(f"[build]   flash decode, fp32 q or cache (two walks): "
          f"{flash_decode.walk_tile_keys()} keys per staged tile; dynamic "
          "shared memory per CTA with the scores of 1024 keys " + ", ".join(
              f"{arch} (G={H // Hkv}, D={D}): "
              f"{flash_decode.walk_smem_bytes(H // Hkv, D, H // Hkv * 1024)}"
              " bytes" for arch, H, Hkv, D, _ in WIDTHS))
    spills = [(name, D, n) for name, D, n
              in ptxas_spills(infos["flash_decode"]["ptxas"])
              if "decode_split" in name]
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills
               if n and D <= 128]
    check(not spilled, "flash_decode.cu: register spills of the split "
          "passes at D <= 128: " + ", ".join(spilled))
    print(f"[build]   flash decode: " + (
        f"{len(spills)} split-pass kernels, none spills at D <= 128"
        if spills else "already built, ptxas not rerun"))
    print("[build]   ssd scan: " + "; ".join(
        f"{str(dt)[6:]} x: {scan_kernel.variant(dt)}"
        for dt in (torch.bfloat16, torch.float32)))
    print("[build]   ssd scan: dynamic shared memory per CTA " + "; ".join(
        f"chunk {Q}, p {p}, n {n}: " + ", ".join(
            f"{name} {nbytes}" for dt in (torch.bfloat16, torch.float32)
            for name, nbytes in scan_kernel.smem_bytes(Q, p, n, dt).items())
        + " bytes"
        for Q, p, n in ((256, 64, 64), (64, 16, 8), (16, 16, 16))))
    for S in (256, 768, 1024):
        pl = scan_kernel.plan(1, S, 80, 64, 64, min(S, 256))
        print(f"[build]   ssd scan plan, zamba2 prefill of {S} tokens (b 1, "
              f"80 heads of 64, state 64, chunk 256), bf16: {pl.chunks} "
              f"chunks of {pl.per_chunk} blocks of {pl.block} tokens; "
              f"CTAs: block states {pl.ctas}, state passing "
              f"{pl.passing_ctas}, block outputs {pl.ctas}; scratch "
              f"{pl.scratch_bytes} bytes")
    hmma = hmma_count(infos["ssd_scan"]["path"])
    check(hmma is None or hmma > 0,
          "ssd_scan.cu: no HMMA (tensor-core) instruction in its SASS")
    spills = [(name, D, n) for name, D, n
              in ptxas_spills(infos["ssd_scan"]["ptxas"])
              if "ssd_block" in name or "ssd_state" in name]
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills if n]
    check(not spilled, "ssd_scan.cu: register spills of the tensor-core "
          "passes: " + ", ".join(spilled))
    print("[build]   ssd scan: " + (
        f"{len(spills)} chunked passes, none spills" if spills
        else "already built, ptxas not rerun"))
    hmma = hmma_count(infos["paged_verify"]["path"])
    check(hmma is None or hmma > 0,
          "paged_verify.cu: no HMMA (tensor-core) instruction in its SASS")
    print("[build]   paged verify: " + "; ".join(
        f"{str(dt)[6:]} q: {paged_verify.variant(dt)}"
        for dt in (torch.bfloat16, torch.float32)))
    spills = ptxas_spills(infos["paged_decode"]["ptxas"])
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills
               if n and (D is None or D <= 128)]
    check(not spilled, "paged_decode.cu: register spills at D <= 128: "
          + ", ".join(spilled))
    print("[build]   paged decode: " + "; ".join(
        f"{str(dt)[6:]} q: {paged_decode.variant(dt)}"
        for dt in (torch.bfloat16, torch.float32))
        + (f"; {len(spills)} kernels, none spills at D <= 128" if spills
           else "; already built, ptxas not rerun"))
    for arch, H, Hkv, D, _ in WIDTHS:
        G = H // Hkv
        plans = []
        for B in (8, 1):
            p = paged_decode.plan(B, G, Hkv, 64, 16, D)
            smem = [paged_decode.smem_bytes(G, D, 16, p.split_keys,
                                            p.splits, dt)
                    for dt in (torch.bfloat16, torch.int8)]
            plans.append(
                f"B {B}: {p.split_keys} keys a split ({p.splits} splits), "
                f"{p.ctas} CTAs a launch, {smem[0]} (bf16 pages) and "
                f"{smem[1]} (int8) bytes of dynamic shared memory a CTA")
        print(f"[build]   {arch} (G={G}, D={D}, page 16, 1024-key tables): "
              "decode, bf16 q: " + "; ".join(plans) + "; decode, fp32 q: "
              f"{paged_decode.fp32_smem_bytes(G, D, 16, G * 1024)} bytes "
              "with the scores of 1024 keys")
        plans = []
        for B, T in ((8, SPEC_K + 1), (1, 64)):
            p = paged_verify.plan(B, T, G, Hkv, 64, 16, D)
            smem = [paged_verify.smem_bytes(D, 16, p.rows, p.split_keys,
                                            p.splits, dt)
                    for dt in (torch.bfloat16, torch.int8)]
            plans.append(
                f"B {B}, T {T}: {p.rows} query rows a tile, {p.split_keys} "
                f"keys a split ({p.splits} splits), {p.ctas} CTAs, "
                f"{smem[0]} (bf16 pages) and {smem[1]} (int8) bytes of "
                "dynamic shared memory a CTA")
        rows = paged_verify.fp32_tile_rows()
        print(f"[build]   {arch}: verify, bf16 q: " + "; ".join(plans)
              + f"; verify, fp32 q: {rows} query rows a CTA, "
              f"{paged_verify.fp32_smem_bytes(D, 16, rows * 1024)} bytes "
              "with the scores of 1024 keys")


def phase_compare(rng) -> dict:
    """Kernel vs plain version; returns the largest error per kernel."""
    worst = {name: 0.0 for name in WRAPPERS}
    bs, NB = 16, 128  # contexts up to 2048
    for arch, H, Hkv, D, window in WIDTHS:
        for B in (1, 8):
            ctx = rng.integers(1, NB * bs + 1, B)
            ctx[0] = NB * bs
            inactive = (B - 1,) if B > 1 else ()
            q, k, v, bt, pos = paged_case(rng, B, H, Hkv, D, bs, NB, ctx,
                                          inactive=inactive)
            rows = [b for b in range(B) if b not in inactive]
            kb, vb = k.bfloat16(), v.bfloat16()
            k8, v8, ks, vs = (t[0] for t in quantized(kb, vb))
            kb, vb = kb[0], vb[0]
            errs = []
            for qd in (q.bfloat16(), q):
                runs = {"paged_decode": (qd, kb, vb, bt, pos),
                        "paged_decode_quant": (qd, k8, v8, ks, vs, bt, pos)}
                for name, args in runs.items():
                    out = WRAPPERS[name](*args, window=window)
                    err32, err = hold(name, out, args,
                                      dict(window=window), rows,
                                      f"{arch} B={B} q {qd.dtype}",
                                      list(inactive) or None)
                    worst[name] = max(worst[name], err)
                    errs.append(f"{name} q {str(qd.dtype)[6:]} {err32:.3g}")
            print(f"[compare] {arch} H={H} Hkv={Hkv} D={D} window={window} "
                  f"B={B}: bf16 and int8 pool, bf16 and fp32 q agree with "
                  f"the plain version"
                  f"{', the free slot too' if inactive else ''}; max |err| "
                  f"vs fp32 plain: " + ", ".join(errs))
    for label, B, H, Hkv, D, NB, window, ctx, inactive in DECODE_EDGES:
        q, k, v, bt, pos = paged_case(rng, B, H, Hkv, D, bs, NB,
                                      np.asarray(ctx), inactive=inactive)
        rows = [b for b in range(B) if b not in inactive]
        kb, vb = k.bfloat16(), v.bfloat16()
        k8, v8, ks, vs = (t[0] for t in quantized(kb, vb))
        kb, vb = kb[0], vb[0]
        errs = []
        for qd in (q.bfloat16(), q):
            runs = {"paged_decode": (qd, kb, vb, bt, pos),
                    "paged_decode_quant": (qd, k8, v8, ks, vs, bt, pos)}
            for name, args in runs.items():
                out = WRAPPERS[name](*args, window=window)
                err32, err = hold(name, out, args, dict(window=window), rows,
                                  f"{label} q {qd.dtype}",
                                  list(inactive) or None)
                worst[name] = max(worst[name], err)
                errs.append(f"{name} q {str(qd.dtype)[6:]} {err32:.3g}")
        split = paged_decode.plan(B, H // Hkv, Hkv, NB, bs, D)
        print(f"[compare] decode, {label}: B={B} H={H} Hkv={Hkv} D={D} "
              f"contexts {ctx} ({split.splits} splits of {split.split_keys} "
              f"keys for bf16 q): bf16 and int8 pool, bf16 and fp32 q agree "
              f"with the plain version"
              f"{', the free slots too' if inactive else ''}; max |err| vs "
              f"fp32 plain: " + ", ".join(errs))
    # verify: the CPU tests' cases (tests/test_torch_speculative.py CASES:
    # B, last context, H, Hkv, D, page, T, window), a 65-page table (its
    # last split ragged), then the three model layouts at the speculative
    # T = 4 (B 8; gemma3-1b's window skips whole splits) and a 64-token
    # chunk (B 2)
    cases = [(2, 96, 8, 2, 64, 16, 4, 0), (1, 64, 4, 4, 32, 8, 3, 24),
             (2, 72, 8, 1, 64, 8, 5, 0), (2, 128, 14, 2, 64, 16, 4, 0),
             (1, 160, 14, 2, 64, 16, 64, 0), (2, 96, 4, 1, 256, 16, 6, 40),
             (2, 1040, 14, 2, 64, 16, 4, 0)]
    for arch, H, Hkv, D, window in WIDTHS:
        cases += [(8, 2048, H, Hkv, D, 16, 4, window),
                  (2, 1024, H, Hkv, D, 16, 64, window)]
    for B, S, H, Hkv, D, bs, T, window in cases:
        NB = S // bs
        ctx = rng.integers(T, S + 1, B)
        ctx[0] = S
        inactive = (B - 1,) if B > 1 else ()
        q, k, v, bt, pos = paged_case(rng, B, H, Hkv, D, bs, NB, ctx, T=T,
                                      inactive=inactive)
        rows = torch.ones(B, T, dtype=torch.bool, device=q.device)
        rows[list(inactive)] = False
        kb, vb = k.bfloat16(), v.bfloat16()
        k8, v8, ks, vs = (t[0] for t in quantized(kb, vb))
        kb, vb = kb[0], vb[0]
        errs = []
        for qd in (q.bfloat16(), q):
            runs = {"paged_verify": (qd, kb, vb, bt, pos),
                    "paged_verify_quant": (qd, k8, v8, ks, vs, bt, pos)}
            for name, args in runs.items():
                out = WRAPPERS[name](*args, window=window)
                err32, err = hold(name, out, args, dict(window=window),
                                  rows,
                                  f"B={B} T={T} H={H} D={D} q {qd.dtype}",
                                  ~rows if inactive else None)
                worst[name] = max(worst[name], err)
                errs.append(f"{name} q {str(qd.dtype)[6:]} {err32:.3g}")
        print(f"[compare] verify B={B} T={T} H={H} Hkv={Hkv} D={D} page "
              f"{bs} window={window}, contexts up to {S}: bf16 and int8 "
              f"pool, bf16 and fp32 q agree with the plain version"
              f"{', the free slot too' if inactive else ''}; max |err| vs "
              f"fp32 plain: " + ", ".join(errs))
    dev = torch.device("cuda")
    flash_runs = [(case[:6], dict(causal=case[6], window=case[7]))
                  for case in FLASH_CASES]
    flash_runs += [(case[:6], dict(causal=True, window=window,
                                   q_offset=q_offset))
                   for *case, window, q_offset in FLASH_OFFSET_CASES]
    for (B, Sq, Sk, H, Hkv, D), kw in flash_runs:
        q = torch.randn(B, Sq, H, D, device=dev)
        k = torch.randn(B, Sk, Hkv, D, device=dev)
        v = torch.randn(B, Sk, Hkv, D, device=dev)
        errs = []
        for dt in (torch.bfloat16, torch.float32):
            args = (q.to(dt), k.to(dt), v.to(dt))
            out = ops.flash_attention(*args, **kw)
            err32, err = hold("flash_attention", out, args, kw, slice(None),
                              f"B={B} Sq={Sq} Sk={Sk} H={H} D={D} {dt}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            errs.append(f"{str(dt)[6:]} {err32:.3g}")
        print(f"[compare] flash attention B={B} Sq={Sq} Sk={Sk} H={H} "
              f"Hkv={Hkv} D={D} "
              + " ".join(f"{key}={val}" for key, val in kw.items())
              + f" (fp32: {flash_attention.plan(B, Sq, Sk, H)} splits): bf16 "
              f"and fp32 agree with the plain version; max |err| vs fp32 "
              f"plain: " + ", ".join(errs))
    for shape in RMS_SHAPES:
        x = torch.randn(shape, device=dev)
        scale = torch.randn(shape[-1], device=dev)
        err_max = 0.0
        for xd, sd, zc in itertools.product(
                (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.float32), (False, True)):
            args, kw = (x.to(xd), scale.to(sd)), dict(zero_centered=zc)
            out = ops.rmsnorm(*args, **kw)
            err32, err = hold("rmsnorm", out, args, kw, slice(None),
                              f"{shape} x {xd} scale {sd} zc {zc}")
            worst["rmsnorm"] = max(worst["rmsnorm"], err)
            err_max = max(err_max, err32)
        rows = int(np.prod(shape[:-1]))
        plans = [rms_kernel.plan(rows, shape[-1], dt)
                 for dt in (torch.bfloat16, torch.float32)]
        print(f"[compare] rmsnorm {list(shape)} (vectors a thread, threads "
              f"a row: bf16 {plans[0]}, fp32 {plans[1]}): bf16 and fp32 x and "
              f"scale, zero-centred or not, agree with the plain version; "
              f"max |err| vs fp32 plain {err_max:.3g}")
    for B, S, H, Hkv, D, window, engine, *extra in DECODE_CASES:
        q, k, v, cpos, pos, rows = dense_case(rng, B, S, H, Hkv, D, engine,
                                              **(extra[0] if extra else {}))
        kb, vb = k.bfloat16(), v.bfloat16()
        k8, v8, ks, vs = dense_quantized(kb, vb, cpos[..., None])
        errs = []
        for qd in (q.bfloat16(), q):
            runs = [("flash_decode", "bf16", (qd, kb, vb, cpos, pos)),
                    ("flash_decode", "fp32", (qd, k, v, cpos, pos)),
                    ("flash_decode_quant", "int8",
                     (qd, k8, v8, ks, vs, cpos, pos))]
            dead = [b for b in range(B) if b not in rows]
            for name, cache, args in runs:
                out = WRAPPERS[name](*args, window=window)
                err32, err = hold(name, out, args, dict(window=window), rows,
                                  f"B={B} S={S} H={H} D={D} {cache} cache "
                                  f"q {qd.dtype}", dead or None)
                worst[name] = max(worst[name], err)
                errs.append(f"{cache} cache, {str(qd.dtype)[6:]} q "
                            f"{err32:.3g}")
        split = flash_decode.plan(B, H // Hkv, Hkv, S, D)
        print(f"[compare] flash decode B={B} S={S} H={H} Hkv={Hkv} D={D} "
              f"window={window}{', engine-like cache' if engine else ''}"
              f"{f', {extra[0]}' if extra else ''} ({split.splits} splits of "
              f"{split.split_keys} keys for bf16 q): "
              f"bf16, fp32 and int8 caches, bf16 and fp32 q agree with the "
              f"plain version"
              f"{f', {len(dead)} slots with no key too' if dead else ''}; "
              f"max |err| vs fp32 plain: " + ", ".join(errs))
    worst["grouped_matmul"] = compare_gmm()
    worst["ssd_scan"] = compare_scan(rng)
    return worst


def hold_gmm(out, x, w, where) -> tuple:
    """Holds a grouped-matmul output to its plain version on the values
    widened to fp32 (GMM_EXACT_TOL) and in the working type (TOL); returns
    both largest errors (0.0 in the working type for fp32)."""
    E, C, _ = x.shape
    check(out.dtype == x.dtype and out.shape == (E, C, w.shape[2]),
          f"grouped_matmul {where}: output {out.dtype} {tuple(out.shape)}")
    a = out.float()
    exact = grouped_matmul_ref(x.float(), w.float()).float()
    err32 = float((a - exact).abs().max())
    check(within(a, exact, GMM_EXACT_TOL[x.dtype]),
          f"grouped_matmul {where}: max |err| {err32} vs the fp32 plain "
          "version")
    if x.dtype == torch.float32:
        return err32, 0.0
    want = grouped_matmul_ref(x, w).float()
    err = float((a - want).abs().max())
    check(within(a, want, TOL["grouped_matmul"]), f"grouped_matmul {where}: "
          f"max |err| {err} vs the plain version")
    return err32, err


def compare_gmm() -> float:
    """The grouped matmul against its plain version in bf16 and fp32 at
    GMM_CASES; returns the largest error in the working type."""
    dev = torch.device("cuda")
    worst = 0.0
    for label, E, C, K, N in GMM_CASES:
        x = torch.randn(E, C, K, device=dev)
        w = torch.randn(E, K, N, device=dev)
        errs = []
        for dt in (torch.bfloat16, torch.float32):
            xd, wd = x.to(dt), w.to(dt)
            err32, err = hold_gmm(ops.grouped_matmul(xd, wd), xd, wd,
                                  f"{label} E={E} C={C} K={K} N={N} {dt}")
            worst = max(worst, err)
            errs.append(f"{str(dt)[6:]} {err32:.3g}")
        print(f"[compare] grouped matmul {label} E={E} C={C} K={K} N={N}: "
              f"bf16 and fp32 agree with the plain version; max |err| vs "
              f"fp32 plain: " + ", ".join(errs))
        del x, w
    return worst


def scan_inputs(rng, b, S, h, p, n, dtype, init=False):
    """SSD-scan inputs on the card, drawn as test_kernels.py::test_ssd_scan
    draws them: x, B, C unit normals in ``dtype``; dt in [0.1, 0.9) and
    a_neg in (-1, -0.1] fp32; with ``init`` a unit-normal initial state."""
    dev = torch.device("cuda")

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return (t(rng.normal(size=(b, S, h, p)), dtype),
            t(rng.uniform(0.1, 0.9, (b, S, h))),
            t(-rng.uniform(0.1, 1.0, (h,))), t(rng.normal(size=(b, S, n)),
                                               dtype),
            t(rng.normal(size=(b, S, n)), dtype),
            t(rng.normal(size=(b, h, p, n))) if init else None)


def hold_scan(y, state, args, chunk, where) -> float:
    """Holds the SSD scan's y and final state to its plain version on the
    same inputs (SCAN_TOL); returns the largest error."""
    x, dt, a_neg, B, C, s0 = args
    b, S, h, p = x.shape
    check(y.dtype == torch.float32 and y.shape == (b, S, h, p)
          and state.dtype == torch.float32
          and state.shape == (b, h, p, B.shape[-1]),
          f"ssd_scan {where}: outputs {y.dtype} {tuple(y.shape)}, "
          f"{state.dtype} {tuple(state.shape)}")
    wy, ws = ssd_scan_ref(x, dt, a_neg, B, C, chunk=min(chunk, S),
                          init_state=s0)
    err = 0.0
    for name, got, want in (("y", y, wy), ("final state", state, ws)):
        check(bool(torch.isfinite(got).all()),
              f"ssd_scan {where}: non-finite {name}")
        e = (got - want).abs()
        rms = float(want.pow(2).mean().sqrt())
        bound = SCAN_TOL["atol_rms"] * rms + SCAN_TOL["rtol"] * want.abs()
        check(bool((e <= bound).all()), f"ssd_scan {where}: {name} off by "
              f"up to {float(e.max())} (RMS {rms:.3g})")
        err = max(err, float(e.max()))
    return err


def compare_scan(rng) -> float:
    """The SSD scan against its plain version at SCAN_CASES, bf16 and fp32
    x, from zeros and from a given state; returns the largest error."""
    worst = 0.0
    for b, S, h, p, n, chunk in SCAN_CASES:
        errs = []
        for dt, init in itertools.product((torch.bfloat16, torch.float32),
                                          (False, True)):
            args = scan_inputs(rng, b, S, h, p, n, dt, init)
            y, state = ops.ssd_scan(*args[:5], chunk=chunk,
                                    init_state=args[5])
            err = hold_scan(y, state, args, chunk,
                            f"b={b} S={S} h={h} p={p} n={n} chunk={chunk} "
                            f"{dt} init={init}")
            worst = max(worst, err)
            errs.append(f"{str(dt)[6:]}{' init' if init else ''} {err:.3g}")
        print(f"[compare] ssd scan b={b} S={S} h={h} p={p} n={n} chunk "
              f"{min(chunk, S)}: y and final state, bf16 and fp32 x, from "
              f"zeros and from a state, agree with the plain version; max "
              f"|err|: " + ", ".join(errs))
    return worst


def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def _gathered(pool, bt, S):
    """[L, P, bs, Hkv, D] pool -> [L, B, Hkv, S, D] contiguous through the
    block table (the library yardstick's input; never timed)."""
    B = bt.shape[0]
    idx = bt.long().clamp(min=0)
    L, _, _, Hkv, D = pool.shape
    return torch.stack([pool[l][idx].reshape(B, S, Hkv, D)
                        .transpose(1, 2).contiguous() for l in range(L)])


def _time_kernel(name, label, q, pools, bt, pos, mask, keys, row_keys,
                 smi, inactive=()) -> dict:
    """Kernel, plain version and one SDPA call on the pre-gathered cache
    (int8: dequantized to bf16 first; gather and dequantization not
    timed), with ``mask`` [B, 1, rows, S] the keys each query row sees;
    one pool per layer so consecutive calls read HBM as the model does.
    ``keys`` distinct keys read per kv head and ``row_keys`` (query row,
    key) pairs per query head: the bound is the larger of the bytes
    (each K/V row once, q in, out, tables, positions) over the HBM rate
    and the q.k plus p.v multiply-adds over the peak rate.  Kernel and
    SDPA are also timed by their device time alone (``device_ms``).
    Slots in ``inactive`` are free: their rows are held to the plain
    version's uniform softmax."""
    L = pools[0].shape[0]
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = pools[0].shape[3]
    wrapper, ref = WRAPPERS[name], PLAINS[name]
    kv_bytes = 2 * keys * Hkv * D * pools[0].element_size()
    if len(pools) == 4:
        kv_bytes += 2 * keys * Hkv * 4  # fp32 row scales
        kg = _gathered(pools[0].float() * pools[2][..., None],
                       bt, mask.shape[-1]).bfloat16()
        vg = _gathered(pools[1].float() * pools[3][..., None],
                       bt, mask.shape[-1]).bfloat16()
    else:
        kg = _gathered(pools[0], bt, mask.shape[-1])
        vg = _gathered(pools[1], bt, mask.shape[-1])
    io_bytes = 2 * q.numel() * q.element_size() + bt.numel() * 4 + B * 4
    ops_count = 4 * H * D * row_keys
    layer = [tuple(p[l] for p in pools) for l in range(L)]
    # [B, H, rows, D]: decode has one row, verify T
    qs = (q[:, :, None] if q.dim() == 3 else q.transpose(1, 2)).contiguous()

    def kernel(i=0):
        wrapper(q, *layer[i % L], bt, pos)

    def plain(i=0):
        ref(q, *layer[i % L], bt, pos)

    def library(i=0):
        F.scaled_dot_product_attention(qs, kg[i % L], vg[i % L],
                                       attn_mask=mask, enable_gqa=True)

    live = torch.ones(qs.shape[0], qs.shape[2], dtype=torch.bool,
                      device=q.device)
    live[list(inactive)] = False
    rows, dead = (live.squeeze(1) if q.dim() == 3 else live), None
    if inactive:
        dead = ~rows
    err32, err = hold(name, wrapper(q, *layer[0], bt, pos),
                      (q,) + layer[0] + (bt, pos), {}, rows,
                      f"{label} shapes", dead)
    bytes_s = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    ops_s = ops_count / PEAK_OPS_PER_S[pools[0].dtype]
    split: dict = {}
    row = {"ms": cuda_ms(kernel, 240),
           "device_ms": device_ms(kernel, by_kernel=split),
           "plain_ms": cuda_ms(plain, 48),
           "library_ms": cuda_ms(library, 240),
           "library_device_ms": device_ms(library),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "main_shapes_max_abs_err": err}
    print(f"[timing] {name} at the {label} shapes: max |err| {err:.3g} vs "
          f"the plain version, {err32:.3g} vs the fp32 plain version")
    print(f"[timing] {name} ({label}): kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
          f"sdpa on the gathered cache {row['library_ms']:.4f} ms (device "
          f"{row['library_device_ms']:.4f} ms), bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"{kv_bytes + io_bytes} bytes, {ops_count} operations), "
          f"{row['bound_ms'] / row['ms']:.2%} of bound, "
          f"{row['bound_ms'] / row['device_ms']:.2%} of it by device time "
          f"({smi})")
    if len(split) > 1:  # the split kernels' passes
        print(f"[timing]   {name} ({label}) device time by kernel: " +
              "; ".join(f"{_short(key)} {ms:.4f} ms"
                        for key, ms in split.items()))
    return row


def _time_verify_at_t1(name, q, pools, bt, pos, row, smi):
    """Paged verify's bf16 tensor-core kernel (``mma.sync``, three passes)
    at T = 1 on the decode inputs, by device time: the alternative to
    paged decode's CUDA-core split passes, timed beside them (``row``) and
    held to paged decode's plain version."""
    twin = name.replace("decode", "verify")
    layer = [tuple(p[l] for p in pools) for l in range(pools[0].shape[0])]
    L = len(layer)
    q1 = q[:, None]
    out = WRAPPERS[twin](q1, *layer[0], bt, pos)[:, 0]
    hold(name, out, (q,) + layer[0] + (bt, pos), {}, slice(None),
         "verify at T = 1 on the decode shapes")
    ms = device_ms(lambda i=0: WRAPPERS[twin](q1, *layer[i % L], bt, pos))
    _, bs, Hkv, D = pools[0].shape[1:]
    p = paged_verify.plan(q.shape[0], 1, q.shape[1] // Hkv, Hkv,
                          bt.shape[1], bs, D)
    print(f"[timing] {twin} at T = 1 on the decode shapes (tensor cores, "
          f"{p.splits} splits, {p.ctas} CTAs): device {ms:.4f} ms against "
          f"{name}'s {row['device_ms']:.4f} ms (CUDA cores) ({smi})")


def phase_timing(rng, smi: str) -> dict:
    """Times at the main path's shapes, qwen2-0.5b heads (14/2, D 64),
    page 16, 24 pools: the decode kernels at B 8 over the mixed contexts
    below (max_seq 1024 tables); the verify kernels at the speculative
    shape (B 8, T 4, the same contexts: 3820 keys), at the same shape with
    its last two slots free (a serving batch that is not full: 1980 keys,
    and the free slots' rows average the null page's 16 value rows) and
    at a prefill chunk (B 1, T 64, the chunk's last query at key 700).
    Returns the kernels-line numbers: decode at its shape, verify at the
    speculative one (the others are printed)."""
    L, H, Hkv, D, bs = 24, 14, 2, 64, 16
    out = {}
    mixed = np.asarray([60, 150, 290, 400, 520, 640, 760, 1000])
    for shape, B, T, NB, ctx, inactive in (
            ("decode", 8, 0, 64, mixed, ()),
            ("decode, one slot", 1, 0, 64, np.asarray([1000]), ()),
            ("decode, 2 free slots", 8, 0, 64, mixed, (6, 7)),
            ("speculative", 8, SPEC_K + 1, 64, mixed, ()),
            ("speculative, 2 free slots", 8, SPEC_K + 1, 64, mixed, (6, 7)),
            ("chunk", 1, 64, 64, np.asarray([700]), ())):
        q, k, v, bt, pos = paged_case(rng, B, H, Hkv, D, bs, NB, ctx, T=T,
                                      layers=L, inactive=inactive)
        q = q.bfloat16()
        kb, vb = k.bfloat16(), v.bfloat16()
        del k, v
        k8, v8, ks, vs = quantized(kb, vb)
        S = NB * bs
        rows = max(T, 1)
        # query row t of slot b sees keys <= pos + t
        qpos = pos[:, None].long() + torch.arange(rows, device=q.device)
        mask = (torch.arange(S, device=q.device)[None, None, None, :]
                <= qpos[:, None, :, None])
        live = [b for b in range(B) if b not in inactive]
        # a free slot's rows read the null page's value rows (once) and
        # take p.v over all S keys (half the work of a visible key)
        keys = int(ctx[live].sum()) + (bs if inactive else 0)
        row_keys = (int((qpos[live] + 1).sum())
                    + len(inactive) * rows * S // 2)
        kind = "verify" if T else "decode"
        for name, pools in ((f"paged_{kind}", (kb, vb)),
                            (f"paged_{kind}_quant", (k8, v8, ks, vs))):
            label = f"{shape} (B={B}{f', T={T}' if T else ''}, contexts " \
                    f"{ctx.tolist()})"
            row = _time_kernel(name, label, q, pools, bt, pos, mask, keys,
                               row_keys, smi, inactive)
            if shape in ("decode", "speculative"):
                out[name] = row
            if shape == "decode":
                _time_verify_at_t1(name, q, pools, bt, pos, row, smi)
        del kb, vb, k8, v8
    return out


def _time_call(name, label, args, kw, nbytes, nops, peak, library,
               smi, rows=slice(None), dead=None) -> dict:
    """Kernel, plain version and one library call (``library(i)``, a
    yardstick the port never calls, for call i) at one shape, the kernel
    held to its plain version there (rows ``rows``; the rows ``dead``
    with no visible key through ``hold_dead``); ``args`` is one argument
    tuple or a list of them, one per layer, taken in turn so that
    consecutive calls read HBM as the model does.  The bound is the larger
    of ``nbytes`` over the HBM rate and ``nops`` over the peak rate of
    ``peak``'s type.  Kernel and library are also printed by their device
    time alone (``device_ms``), a kernel of several launches by launch too:
    where a call's kernels are shorter than the host's time to issue it,
    back-to-back calls measure the host."""
    wrapper, ref = WRAPPERS[name], PLAINS[name]
    layers = args if isinstance(args, list) else [args]
    L = len(layers)
    first = wrapper(*layers[0], **kw)
    if name == "grouped_matmul":
        err32, err = hold_gmm(first, *layers[0], f"{label} shapes")
    else:
        err32, err = hold(name, first, layers[0], kw, rows,
                          f"{label} shapes", dead)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = nops / PEAK_OPS_PER_S[peak]
    split: dict = {}
    row = {"ms": cuda_ms(lambda i=0: wrapper(*layers[i % L], **kw), 240),
           "device_ms": device_ms(
               lambda i=0: wrapper(*layers[i % L], **kw), by_kernel=split),
           "plain_ms": cuda_ms(lambda i=0: ref(*layers[i % L], **kw), 48),
           "library_ms": cuda_ms(library, 240),
           "library_device_ms": device_ms(library),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "main_shapes_max_abs_err": err}
    print(f"[timing] {name} ({label}): kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f} ms), plain "
          f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
          f"(device {row['library_device_ms']:.4f} ms), "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} "
          f"bytes, {nops} operations at the {str(peak)[6:]} peak), "
          f"{row['bound_ms'] / row['ms']:.2%} of bound "
          f"({row['bound_ms'] / row['device_ms']:.2%} by device time); max "
          f"|err| {err:.3g} vs the plain version, {err32:.3g} vs the fp32 "
          f"plain version ({smi})")
    if len(split) > 1:
        print(f"[timing]   {name} ({label}) device time by kernel: " +
              "; ".join(f"{_short(key)} {ms:.4f} ms"
                        for key, ms in split.items()))
    return row


def phase_timing_new(smi: str) -> dict:
    """Flash attention and RMSNorm at the main path's shapes.  Flash: the
    encoder's batch of four 128x128 images (B 4, S 256, two heads of 448,
    fp32, non-causal; the kernels-line entry), its four 32x32 images
    (S 16), the draft's causal prefill at qwen2-0.5b heads for each
    prompt bucket the smoke's requests reach (B 1, S 64-1024, bf16) and
    zamba2-2.7b's shared attention at its longest prompt (B 1, S 768, 32
    heads of 80, causal bf16); each row names the instantiation that ran;
    the yardstick is ``F.scaled_dot_product_attention`` on [B, H, S, D]
    copies (``enable_gqa``, ``is_causal``).  RMSNorm: a decode tick
    [8, 896] (the kernels-line entry) and a prefill chunk [64, 896] of
    bf16 activations with bf16 scales, and the encoder's [1024, 896] in
    fp32; the yardstick is ``F.rms_norm`` with the scale in x's type.
    The flash bound counts the visible (query, key) pairs' q.k and p.v
    multiply-adds (2 flops each) at the peak of the inputs' type: bf16
    989 TFLOP/s (the tensor cores, on which the bf16 instantiation
    multiplies), fp32 67 TFLOP/s (outside the tensor cores: the fp32
    instantiation multiplies on the CUDA cores, never in TF32)."""
    dev = torch.device("cuda")
    out = {}
    shapes = [("encoder 128x128", 4, 256, 2, 2, 448, torch.float32, False),
              ("encoder 32x32", 4, 16, 2, 2, 448, torch.float32, False)]
    shapes += [(f"draft prefill S {S}", 1, S, 14, 2, 64, torch.bfloat16,
                True) for S in (64, 128, 256, 512, 1024)]
    shapes += [("zamba2 shared attention", 1, 768, 32, 32, 80,
                torch.bfloat16, True)]
    for label, B, S, H, Hkv, D, dt, causal in shapes:
        q = torch.randn(B, S, H, D, device=dev, dtype=dt)
        k = torch.randn(B, S, Hkv, D, device=dev, dtype=dt)
        v = torch.randn(B, S, Hkv, D, device=dev, dtype=dt)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * (S * (S + 1) // 2 if causal else S * S)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()

        def library(i=0, qt=qt, kt=kt, vt=vt, causal=causal):
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)

        row = _time_call("flash_attention",
                         f"{label}: B={B} S={S} H={H}/{Hkv} D={D} "
                         f"{'causal' if causal else 'non-causal'}; "
                         f"{flash_attention.variant(D, dt)}",
                         (q, k, v), dict(causal=causal), nbytes,
                         4 * pairs * H * D, dt, library, smi)
        out.setdefault("flash_attention", row)
    for label, shape, dt in (("decode tick", (8, 896), torch.bfloat16),
                             ("prefill chunk", (64, 896), torch.bfloat16),
                             ("encoder", (1024, 896), torch.float32)):
        x = torch.randn(shape, device=dev, dtype=dt)
        scale = torch.randn(shape[-1], device=dev, dtype=dt)
        nbytes = 2 * x.numel() * x.element_size() \
            + scale.numel() * scale.element_size()

        def library(i=0, x=x, scale=scale):
            F.rms_norm(x, (x.shape[-1],), weight=scale, eps=1e-6)

        row = _time_call("rmsnorm", f"{label} {list(shape)} {str(dt)[6:]}",
                         (x, scale), {}, nbytes, 3 * x.numel(), dt, library,
                         smi)
        out.setdefault("rmsnorm", row)
    out.update(_time_flash_decode(smi))
    out.update(_time_gmm(smi))
    out.update(_time_scan(smi))
    return out


def _time_scan(smi: str) -> dict:
    """The SSD scan at a zamba2-2.7b prefill: b 1, 80 heads of 64, state
    64, chunk 256, bf16 x, B and C, S 256 (one chunk), 768 (three; phase
    9c's longest prompt) and 1024 (four; the kernels-line entry), by CUDA
    events and by device time alone (``device_ms``, with each pass's
    kernel).  Eight input sets are taken in turn, so each call reads its
    inputs from HBM as a layer of the model does.  The bound counts x, dt,
    a_neg, B, C, y and the final state once against the causal work: per
    (head, chunk) Q(Q+1)/2 visible (query, key) pairs of C.B (n
    multiply-adds each) and of scores.xd (p each), then C.state and the
    state update (Q n p each), at the bf16 peak (the inputs' type).  No
    single PyTorch call computes the scan: there is no library yardstick
    (library ms: none)."""
    rng = np.random.default_rng(11)
    b, h, p, n, chunk = 1, 80, 64, 64, 256
    out = {}
    for S in (256, 768, 1024):
        sets = [scan_inputs(rng, b, S, h, p, n, torch.bfloat16)
                for _ in range(8)]
        Q = min(chunk, S)
        x, dt, a_neg, B, C, _ = sets[0]
        nbytes = sum(t.numel() * t.element_size()
                     for t in (x, dt, a_neg, B, C)) \
            + 4 * (b * S * h * p + b * h * p * n)
        nops = b * h * (S // Q) * (Q * (Q + 1) * (n + p) + 4 * Q * n * p)
        y, state = ops.ssd_scan(x, dt, a_neg, B, C, chunk=chunk)
        err = hold_scan(y, state, sets[0], chunk, f"timing S={S}")
        split: dict = {}
        row = {"ms": cuda_ms(lambda i=0: ops.ssd_scan(
                   *sets[i % 8][:5], chunk=chunk), 240),
               "device_ms": device_ms(lambda i=0: ops.ssd_scan(
                   *sets[i % 8][:5], chunk=chunk), by_kernel=split),
               "plain_ms": cuda_ms(lambda i=0: ssd_scan_ref(
                   *sets[i % 8][:5], chunk=Q), 24),
               "library_ms": None, "main_shapes_max_abs_err": err}
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = nops / PEAK_OPS_PER_S[torch.bfloat16]
        row["bound_ms"] = max(bytes_s, ops_s) * 1e3
        row["bound_by"] = "bytes" if bytes_s >= ops_s else "operations"
        print(f"[timing] ssd_scan (zamba2 prefill: b={b} S={S} h={h} p={p} "
              f"n={n} chunk {Q}, bf16 x): kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
              f"library: none (no single PyTorch call computes the SSD "
              f"scan), bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
              f"{nbytes} bytes, {nops} operations at the bf16 peak), "
              f"{row['bound_ms'] / row['ms']:.2%} of bound "
              f"({row['bound_ms'] / row['device_ms']:.2%} by device time); "
              f"max |err| {err:.3g} vs the plain version ({smi})")
        if len(split) > 1:
            print(f"[timing]   ssd_scan (S={S}) device time by kernel: " +
                  "; ".join(f"{_short(key)} {ms:.4f} ms"
                            for key, ms in split.items()))
        out["ssd_scan"] = row
        del sets
    return out


def _time_gmm(smi: str) -> dict:
    """The grouped matmul at the MoE path's shapes, bf16: granite-moe's
    experts (E 32, d 1024, ff 512) at a decode tick (C 8; gate/up, the
    kernels-line entry, and down), a verify pass (C 16), a 64-token chunk
    (C 24) and a 1024-token bucket (C 320; gate/up and down), and
    qwen2-moe-a2.7b's (E 60, d 2048, ff 1408) at a decode tick and a
    1024-token bucket (C 88, gate/up).  Each row names the instantiation
    that ran.  The weights of 24 layers (4 for qwen2-moe: 346 MB each)
    are taken in turn, so each call reads them from HBM as the model does.
    The bound counts x, w and the output once against 2*E*C*K*N
    operations at the bf16 tensor-core peak; the yardstick is
    ``torch.bmm`` on the same operands."""
    dev = torch.device("cuda")
    out = {}
    for label, E, C, K, N, L in (
            ("granite decode gate/up", 32, 8, 1024, 512, 24),
            ("granite decode down", 32, 8, 512, 1024, 24),
            ("granite verify gate/up", 32, 16, 1024, 512, 24),
            ("granite chunk gate/up", 32, 24, 1024, 512, 24),
            ("granite monolithic gate/up", 32, 320, 1024, 512, 24),
            ("granite monolithic down", 32, 320, 512, 1024, 24),
            ("qwen2-moe decode gate/up", 60, 8, 2048, 1408, 4),
            ("qwen2-moe monolithic gate/up", 60, 88, 2048, 1408, 4)):
        w = torch.randn(L, E, K, N, device=dev, dtype=torch.bfloat16)
        x = torch.randn(E, C, K, device=dev, dtype=torch.bfloat16)
        nbytes = 2 * (x.numel() + E * K * N + E * C * N)

        def library(i=0, x=x, w=w, L=L):
            torch.bmm(x, w[i % L])

        row = _time_call("grouped_matmul",
                         f"{label}: E={E} C={C} K={K} N={N} bf16; "
                         f"{moe_gmm.variant(torch.bfloat16, C)}",
                         [(x, w[l]) for l in range(L)], {}, nbytes,
                         2 * E * C * K * N, torch.bfloat16, library, smi)
        out.setdefault("grouped_matmul", row)
        del w
    return out


# flash decode's timing shapes (phase 4): (label, B, H, Hkv, D, contexts,
# free slots, caches): the dense path's decode shape (qwen2-0.5b heads, B
# 8, the kernels-line entry), one slot at a 1000-token context (an edge
# server's light load), the decode shape with its last two slots free, and
# zamba2-2.7b's shared attention (B 8, 32/32 heads of 80; nine caches, its
# nine calls a tick)
FLASH_DECODE_TIMING = [
    ("dense decode", 8, 14, 2, 64, DENSE_CTX, (), 24),
    ("one slot", 1, 14, 2, 64, np.asarray([1000]), (), 24),
    ("2 free slots", 8, 14, 2, 64, DENSE_CTX, (6, 7), 24),
    ("zamba2 shared attention", 8, 32, 32, 80, DENSE_CTX, (), 9)]


def _time_flash_decode(smi: str) -> dict:
    """Flash decode at the dense path's shapes (FLASH_DECODE_TIMING): a
    max_seq 1024 cache per layer (taken in turn) holding the given
    contexts (-1 past each; free slots all -1 at pos 0), bf16 and int8
    caches, bf16 q; each row by device time per launch too.  The bound
    counts q and the output, every cache_positions entry and pos, each
    visible K/V row (int8: and its two fp32 scales) once and, for a free
    slot, its S value rows (and scales) once, against the q.k and p.v
    multiply-adds of the visible keys and the p.v of a free slot's S keys
    at the cache type's peak; the yardstick is SDPA on each layer's cache
    viewed [B, Hkv, S, D] (``enable_gqa``) with a per-row mask of the
    visible keys, every key for a free slot (int8: on the cache
    dequantized to bf16 beforehand, not timed).  Returns the kernels-line
    numbers (the dense decode shape)."""
    rng = np.random.default_rng(3)
    S = 1024
    out = {}
    for label, B, H, Hkv, D, ctx, free, L in FLASH_DECODE_TIMING:
        q, k, v, cpos, pos, rows = dense_case(rng, B, S, H, Hkv, D, True,
                                              layers=L, ctx=ctx, free=free)
        pos = torch.from_numpy(np.where(np.isin(np.arange(B), free), 0,
                                        ctx - 1).astype(np.int32)).cuda()
        q = q.bfloat16()
        kb, vb = k.bfloat16(), v.bfloat16()
        del k, v
        k8, v8, ks, vs = dense_quantized(kb, vb, cpos[..., None])
        live = [b for b in range(B) if b not in free]
        keys = int(ctx[live].sum())
        seen = (cpos >= 0) & (cpos <= pos[:, None])
        seen[list(free)] = True  # a free slot's uniform softmax: every key
        mask = seen[:, None, None, :]
        qs = q[:, :, None]  # [B, H, 1, D]
        io = 2 * q.numel() * q.element_size() + cpos.numel() * 4 + B * 4
        nops = 4 * H * D * keys + 2 * H * D * S * len(free)
        for name, caches in (("flash_decode", (kb, vb)),
                             ("flash_decode_quant", (k8, v8, ks, vs))):
            es = caches[0].element_size()
            nbytes = io + (2 * keys + S * len(free)) * Hkv * D * es
            if len(caches) == 4:  # fp32 row scales
                nbytes += (2 * keys + S * len(free)) * Hkv * 4
                kg = (k8.float() * ks[..., None]).bfloat16()
                vg = (v8.float() * vs[..., None]).bfloat16()
            else:
                kg, vg = kb, vb
            layers = [tuple(c[l] for c in caches) + (cpos, pos)
                      for l in range(L)]

            def library(i=0, kg=kg, vg=vg, L=L, qs=qs, mask=mask):
                F.scaled_dot_product_attention(
                    qs, kg[i % L].transpose(1, 2), vg[i % L].transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)

            row = _time_call(
                name, f"{label}: B={B} S={S} H={H}/{Hkv} D={D}, "
                f"{'int8' if len(caches) == 4 else 'bf16'} cache, contexts "
                f"{ctx.tolist()}{f', slots {list(free)} free' if free else ''}",
                [(q,) + lay for lay in layers], {}, nbytes, nops,
                caches[0].dtype, library, smi, rows=live,
                dead=list(free) or None)
            if label == "dense decode":
                out[name] = row
            del kg, vg
        del kb, vb, k8, v8, ks, vs
    return out


def _prompts(rng, vocab):
    """12 prompts of 48-700 tokens; the even ones share a 256-token
    prefix."""
    shared = rng.integers(0, vocab, 256)
    prompts = []
    for i in range(12):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, int(rng.integers(44, 445)))
            prompts.append(np.concatenate([shared, tail]))
        else:
            prompts.append(rng.integers(0, vocab, int(rng.integers(48, 701))))
    return prompts


def _engine(model, params, kv_dtype, telemetry=None, **kw):
    """An engine for the main path whose first cuBLAS calls and caches are
    already warm (one short request, then metrics and prefix cache reset);
    ``kw`` reaches the engine (the speculation knobs)."""
    vocab = model.cfg.vocab
    eng = ServingEngine(model, params, max_batch=8, page_size=16,
                        max_seq=1024, kv_dtype=kv_dtype, device="cuda",
                        telemetry=telemetry, **kw)
    eng.submit(Request(-1, np.arange(40) % vocab, max_new_tokens=4))
    eng.run_until_drained()
    eng.metrics.reset()
    eng.reset_prefix_cache()
    if telemetry is not None:
        telemetry.tracer.clear()
    return eng


def _warm_engine(model, params, kv_dtype, telemetry=None, **kw):
    """A warm engine (``_engine``) and the 12 text requests it is to
    serve."""
    eng = _engine(model, params, kv_dtype, telemetry, **kw)
    reqs = [Request(i, p, max_new_tokens=32)
            for i, p in enumerate(_prompts(np.random.default_rng(1),
                                           model.cfg.vocab))]
    return eng, reqs


def _drive(eng, reqs) -> "tuple[float, dict, dict]":
    """Serve ``reqs`` with every launch count set to 0 just before; returns
    the wall time, the counts read just after, and the engine's stats.
    ``reqs`` may be a callable run after the counts are zeroed that makes
    the requests (the multimodal path encodes its media there).  Every
    request must get its full budget of in-vocabulary tokens.  Engines of
    earlier runs are collected first (an engine's metric views refer back
    to it, so only the cycle collector frees its cache), so the peak
    memory is this run's."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    if callable(reqs):
        reqs = reqs()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in WRAPPERS.items()}
    vocab = eng.model.cfg.vocab
    for r in reqs:
        check(r.done and len(r.output) == 32,
              f"request {r.uid}: {len(r.output)} tokens, done={r.done}")
        check(all(0 <= t < vocab for t in r.output),
              f"request {r.uid}: token id out of range")
    return wall, counts, eng.stats()


def _latency_line(st, wall) -> str:
    lat = st["latency"]
    return (f"TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms p95 "
            f"{lat['ttft_p95_s'] * 1e3:.1f} ms; e2e p50 "
            f"{lat['e2e_p50_s']:.3f} s p95 {lat['e2e_p95_s']:.3f} s; ITL "
            f"p50 {lat['itl_p50_s'] * 1e3:.2f} ms p95 "
            f"{lat['itl_p95_s'] * 1e3:.2f} ms; decode "
            f"{st['decode_tokens'] / wall:.1f} tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main_model():
    """qwen2-0.5b at full width and MAIN_LAYERS of its layers, random bf16
    weights, on the card."""
    full = get_config("qwen2-0.5b")
    cfg = dataclasses.replace(full, n_layers=MAIN_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] qwen2-0.5b full width: {cfg.n_layers} of its "
          f"{full.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, bf16 weights drawn on the card "
          f"from seed 0 in {time.perf_counter() - t0:.2f} s")
    return model, params


def norms_per_step(cfg) -> int:
    """RMSNorm launches of one step of ``cfg``'s model (a decode step, a
    prefill chunk, a verify pass, a draft step or a draft prefill): ln1 and
    ln2 of every layer, the post-norms and the two qk-norms where the
    config has them, and the final norm."""
    check(cfg.norm in ("rmsnorm", "rmsnorm_zero"),
          f"{cfg.name}: {cfg.norm} runs no RMSNorm kernel")
    per_layer = 2 + 2 * bool(cfg.post_norms) + 2 * bool(cfg.qk_norm)
    return cfg.n_layers * per_layer + 1


def encoder_norms() -> int:
    """RMSNorm launches of one encode call: ln1 and ln2 of every block and
    the final norm."""
    return 2 * ENC_CFG.n_layers + 1


def phase_main_path(model, params, smi: str):
    """Returns the launch count of each paged kernel in its pool's run and
    the streams each pool's run gave (phase 6 compares speculation to
    them).  Decode launches n_layers per decode step, verify (the
    chunked-prefill attention) n_layers per prefill chunk, RMSNorm the
    norms of every decode step and chunk; flash attention and the other
    pool's kernels never."""
    L = model.cfg.n_layers
    launches, streams = {}, {}
    for kv_dtype in ("bf16", "int8"):
        eng, reqs = _warm_engine(model, params, kv_dtype)
        wall, counts, st = _drive(eng, reqs)
        check(st["prefix_hits"] > 0, "no prefix-cache hit on the main path")
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        want = {n: 0 for n in WRAPPERS}
        q = "_quant" if kv_dtype == "int8" else ""
        want[f"paged_decode{q}"] = L * steps
        want[f"paged_verify{q}"] = L * chunks
        want["rmsnorm"] = norms_per_step(model.cfg) * (steps + chunks)
        check(counts == want, f"{kv_dtype} pool launched {counts}, want "
              f"{want} ({steps} decode steps, {chunks} prefill chunks)")
        launches.update({n: counts[n] for n in (f"paged_decode{q}",
                                                f"paged_verify{q}")})
        streams[kv_dtype] = [tuple(r.output) for r in reqs]
        print(f"[main] {kv_dtype} pool: 12 requests, prompts "
              f"{sum(len(r.tokens) for r in reqs)} tokens "
              f"({st['prefix_tokens_reused']} reused, {st['prefix_hits']} "
              f"prefix hits) in {chunks} prefill chunks, "
              f"{st['decode_tokens']} decode tokens in {steps} decode "
              f"steps, {wall:.3f} s wall; {_latency_line(st, wall)}; "
              f"launches: paged_decode{q} {want[f'paged_decode{q}']} = "
              f"{L} x {steps}, paged_verify{q} {want[f'paged_verify{q}']} "
              f"= {L} x {chunks}, rmsnorm {want['rmsnorm']} = "
              f"{norms_per_step(model.cfg)} x ({steps} + {chunks}) ({smi})")
    return launches, streams


def _cut_draft(cfg, params, n_layers):
    """A draft made of the target's embed, first ``n_layers`` layers and
    final norm (views of the same weights)."""
    layers = _tree_map(lambda t: t[:n_layers], params["layers"])
    return (dataclasses.replace(cfg, n_layers=n_layers),
            {**params, "layers": layers})


def phase_speculation(model, params, streams, smi: str) -> dict:
    """The speculative path at full width: the 12 requests with spec_k=3,
    a bf16 pool drafted by the target itself and an int8 pool drafted by a
    4-layer cut of it.  The draft's decode steps run the flash-decode
    kernel, n_layers of the draft per step.  Returns each verify kernel's
    launches in its pool's run and the self-draft's flash-decode
    launches."""
    cfg = model.cfg
    L = cfg.n_layers
    launches = {}
    for kv_dtype, label, (dcfg, dparams) in (
            ("bf16", "self-draft (the target's own weights)",
             (cfg, params)),
            ("int8", "4-layer draft (the target's embed, layers 0-3, "
             "final norm)", _cut_draft(cfg, params, 4))):
        tel = Telemetry(trace=True)
        eng, reqs = _warm_engine(model, params, kv_dtype, tel,
                                 draft_config=dcfg, draft_params=dparams,
                                 spec_k=SPEC_K)
        wall, counts, st = _drive(eng, reqs)
        ticks, chunks = st["verify_steps"], st["prefill_chunks"]
        installs, dsteps = st["draft_prefills"], st["draft_steps"]
        check(dsteps == SPEC_K * ticks, f"{dsteps} draft steps in {ticks} "
              f"ticks of spec_k={SPEC_K}")
        q = "_quant" if kv_dtype == "int8" else ""
        want = {n: 0 for n in WRAPPERS}
        want[f"paged_verify{q}"] = L * (ticks + chunks)
        want["flash_attention"] = dcfg.n_layers * installs
        want["flash_decode"] = dcfg.n_layers * dsteps
        want["rmsnorm"] = (norms_per_step(cfg) * (ticks + chunks)
                           + norms_per_step(dcfg) * (SPEC_K * ticks
                                                     + installs))
        check(counts == want, f"speculative {kv_dtype} pool launched "
              f"{counts}, want {want} ({ticks} verify passes, {chunks} "
              f"prefill chunks, {installs} draft prefills)")
        launches[f"paged_verify{q}"] = counts[f"paged_verify{q}"]
        if dparams is params:
            launches["flash_decode"] = counts["flash_decode"]
        rate = eng.acceptance_rate()
        if dparams is params:
            check(rate >= 0.5, f"self-draft acceptance {rate:.3f} < 0.5: "
                  "the verify path disagrees with decode")
        spans = {}
        for ev in tel.tracer.events:
            if ev.get("ph") == "X" and ev["name"] in ("draft_tick",
                                                      "verify_tick"):
                n, t = spans.get(ev["name"], (0, 0.0))
                spans[ev["name"]] = (n + 1, t + ev["dur"] / 1e6)
        same = sum(tuple(r.output) == o
                   for r, o in zip(reqs, streams[kv_dtype]))
        slot_ticks = st["spec_tokens_drafted"] // SPEC_K
        print(f"[spec] {kv_dtype} pool, {label}, spec_k={SPEC_K}: "
              f"{st['decode_tokens']} decode tokens in {ticks} verify "
              f"passes ({st['decode_tokens'] / ticks:.2f} tokens per pass, "
              f"{st['decode_tokens'] / slot_ticks:.2f} per slot per pass), "
              f"acceptance {rate:.3f} ({st['spec_tokens_accepted']} of "
              f"{st['spec_tokens_drafted']} drafts), {wall:.3f} s wall; "
              f"{_latency_line(st, wall)}; spans (host clock): " +
              "; ".join(f"{n} {c} x {t:.4f} s"
                        for n, (c, t) in sorted(spans.items())) +
              f"; streams equal to the spec-off run: {same} of "
              f"{len(reqs)}; launches: paged_verify{q} "
              f"{counts[f'paged_verify{q}']} = {L} x ({ticks} + {chunks}), "
              f"flash_attention {want['flash_attention']} = "
              f"{dcfg.n_layers} x {installs} draft prefills, flash_decode "
              f"{want['flash_decode']} = {dcfg.n_layers} x {dsteps} draft "
              f"steps, rmsnorm "
              f"{want['rmsnorm']} = {norms_per_step(cfg)} x ({ticks} + "
              f"{chunks}) + {norms_per_step(dcfg)} x ({SPEC_K} x {ticks} + "
              f"{installs}) ({smi})")
    return launches


def mm_media():
    """The multimodal path's media, from data/taskgen.py (seed 0): four
    32x32 images (fig11's size, 16 patches) and four 128x128 images (256
    patches, the encoder's max_span) of image-bound tasks, and three clips
    of 24 frames x 16 mel bins of audio-bound tasks."""
    tasks = make_taskset(seed=0)
    img = [i for i in range(tasks.n) if tasks.modality_name(i) == "image"]
    aud = [i for i in range(tasks.n) if tasks.modality_name(i) == "audio"]
    return {"small": tasks.images(img[:4], 32),
            "large": tasks.images(img[4:8], 128),
            "audio": np.stack([tasks.audio(i, AUDIO_FRAMES,
                                           ENC_CFG.audio_dim)
                               for i in aud[:3]])}


def encode_media(eparams, media) -> "tuple[dict, dict]":
    """Three encode calls on the card, one per batch; returns the host
    features [B, kept, 896] per batch and each call's milliseconds (host
    clock, upload and download included)."""
    feats, ms = {}, {}
    for key, fn in (("small", enc.encode_image), ("large", enc.encode_image),
                    ("audio", enc.encode_audio)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = fn(ENC_CFG, eparams, torch.from_numpy(media[key]).to("cuda"))
        feats[key] = f.cpu().numpy()
        ms[key] = (time.perf_counter() - t0) * 1e3
    return feats, ms


MM_ORDER = [("large", 0), ("small", 0), ("audio", 0), ("large", 1),
            ("small", 1), ("audio", 1), ("large", 2), ("small", 2),
            ("audio", 2), ("large", 3), ("small", 3), ("large", 0)]


def mm_requests(vocab, feats, *, new_tokens=32, heads=(8, 25),
                tails=(48, 401), seed=5):
    """One request per MM_ORDER entry: a text head, the media span and a
    text tail, ``new_tokens`` each.  The last request repeats the first
    one's head and image (a second client sending the same picture), so it
    must reuse their pages through the prefix trie."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (kind, j) in enumerate(MM_ORDER):
        if i == len(MM_ORDER) - 1:
            head, span = reqs[0].segments[0].tokens, feats[kind][j].copy()
        else:
            head = rng.integers(0, vocab, int(rng.integers(*heads)))
            span = feats[kind][j]
        tail = rng.integers(0, vocab, int(rng.integers(*tails)))
        segs = [TextSegment(head),
                EmbedSegment(span, "audio" if kind == "audio" else "image"),
                TextSegment(tail)]
        reqs.append(Request(i, segments=segs, max_new_tokens=new_tokens))
    return reqs


def _shared_prefix(a, b) -> int:
    n = min(len(a), len(b))
    diff = np.nonzero(np.asarray(a[:n]) != np.asarray(b[:n]))[0]
    return int(diff[0]) if len(diff) else n


def phase_multimodal(model, params, smi: str) -> dict:
    """The multimodal path at full width: media from taskgen through the
    edge encoder on the card (fig11's settings at d 896, fp32, seed 17),
    then 12 requests of text head + media span + text tail through the
    engine: a bf16 pool, an int8 pool, and the bf16 pool with speculation
    (spec_k=3, self-draft).  The encoding runs inside the counted window.
    Launches must be exactly: flash attention = encoder layers x 3 encode
    calls (+ draft layers x draft prefills); RMSNorm = the norms of every
    encode call, decode step, prefill chunk, verify pass, draft step and
    draft prefill; flash decode = n_layers x draft steps; the paged
    kernels of the run's pool as on the text path; nothing of the other
    pool.  Returns the speculative run's counts."""
    cfg = model.cfg
    L, Le = cfg.n_layers, ENC_CFG.n_layers
    t0 = time.perf_counter()
    eparams = enc.init_mm_encoder(ENC_CFG, ENC_SEED, device="cuda")
    media = mm_media()
    feats, ms = encode_media(eparams, media)  # warm: cuBLAS, the kernels
    print(f"[mm] encoder: d {ENC_CFG.d_model}, {Le} layers, "
          f"{ENC_CFG.n_heads} heads of {ENC_CFG.d_model // ENC_CFG.n_heads},"
          f" d_ff {ENC_CFG.d_ff}, keep_ratio 1/3, fp32 params from seed "
          f"{ENC_SEED} in {time.perf_counter() - t0:.1f} s; features " +
          ", ".join(f"{k} {list(v.shape)}" for k, v in feats.items()) +
          " (first call: " + ", ".join(f"{k} {v:.1f} ms"
                                      for k, v in ms.items()) + ")")
    for f in feats.values():
        check(bool(np.isfinite(f).all()), "non-finite encoder features")
    check(feats["large"].shape[1] == ENC_CFG.kept(256)
          and feats["small"].shape[1] == ENC_CFG.kept(16)
          and feats["audio"].shape[1] == ENC_CFG.kept(AUDIO_FRAMES),
          f"keep-top-k spans {[f.shape for f in feats.values()]}")
    out, streams = {}, {}
    for kv_dtype, spec in (("bf16", False), ("int8", False),
                           ("bf16", True)):
        kw = dict(draft_config=cfg, draft_params=params,
                  spec_k=SPEC_K) if spec else {}
        eng = _engine(model, params, kv_dtype, **kw)
        box = {}

        def prepare(box=box):
            box["feats"], box["ms"] = encode_media(eparams, media)
            box["reqs"] = mm_requests(cfg.vocab, box["feats"])
            return box["reqs"]

        wall, counts, st = _drive(eng, prepare)
        reqs = box["reqs"]
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        ticks, installs = st["verify_steps"], st["draft_prefills"]
        q = "_quant" if kv_dtype == "int8" else ""
        want = {n: 0 for n in WRAPPERS}
        want["flash_attention"] = Le * 3 + L * installs
        want["flash_decode"] = L * st["draft_steps"]
        want["rmsnorm"] = (norms_per_step(cfg) * (steps + chunks + ticks)
                           + encoder_norms() * 3
                           + norms_per_step(cfg) * (SPEC_K * ticks
                                                    + installs))
        want[f"paged_decode{q}"] = L * steps
        want[f"paged_verify{q}"] = L * (chunks + ticks)
        label = f"{kv_dtype} pool" + (f", spec_k={SPEC_K} self-draft"
                                      if spec else "")
        check(counts == want, f"multimodal {label} launched {counts}, want "
              f"{want} ({steps} decode steps, {chunks} prefill chunks, "
              f"{ticks} verify passes, {installs} draft prefills)")
        check(spec == (ticks > 0 and steps == 0),
              f"multimodal {label}: {steps} decode steps, {ticks} verify "
              "passes")
        # the repeated head + image: every full page of their key ids
        keys = [r.tokens for r in (reqs[0], reqs[-1])]
        shared = _shared_prefix(*keys) // eng.page_size * eng.page_size
        check(shared > len(reqs[0].segments[0].tokens)
              and st["prefix_tokens_reused"] >= shared
              and st["prefix_hits"] > 0,
              f"multimodal {label}: the repeated image was not reused "
              f"({st['prefix_tokens_reused']} tokens reused, {shared} "
              f"shared, {st['prefix_hits']} hits)")
        streams[label] = [tuple(r.output) for r in reqs]
        media_rows = sum(len(r.segments[1].features) for r in reqs)
        extra = ""
        if spec:
            same = sum(a == b for a, b in zip(streams[label],
                                              streams["bf16 pool"]))
            extra = (f"; acceptance {eng.acceptance_rate():.3f}, "
                     f"{st['decode_tokens'] / ticks:.2f} tokens per verify "
                     f"pass, streams equal to the spec-off run: {same} of "
                     f"{len(reqs)}")
            out = counts
        print(f"[mm] {label}: 12 requests, prompts "
              f"{sum(len(r.tokens) for r in reqs)} positions ({media_rows} "
              f"media rows; {st['prefix_tokens_reused']} reused, "
              f"{st['prefix_hits']} prefix hits, the repeated image's "
              f"{shared} shared positions) in {chunks} prefill chunks; "
              f"encoder per batch " + ", ".join(
                  f"{k} {v:.2f} ms" for k, v in box["ms"].items()) +
              f"; {st['decode_tokens']} decode tokens, {wall:.3f} s wall; "
              f"{_latency_line(st, wall)}{extra}; launches " +
              ", ".join(f"{n} {c}" for n, c in counts.items() if c) +
              f" ({smi})")
    return out


def phase_dense(model, params, streams, smi: str) -> dict:
    """The dense backend and monolithic prefill at full width: the 12 text
    requests of phase 5 through a dense engine with chunked prefill
    (``prefill_chunk=64``; its chunks attend through the plain version, as
    in the JAX package), a dense engine with monolithic prefill and paged
    engines with monolithic prefill (bf16 and int8 pools; the prompts that
    share a prefix attend it through ``prefill_with_prefix``).  Launches
    must be exactly: flash decode = n_layers x dense decode steps; flash
    attention = n_layers x monolithic prefills, with or without a prefix;
    the paged decode kernel of the pool n_layers x paged decode steps;
    RMSNorm the norms of every step, chunk and prefill; nothing else.
    Returns the dense chunked run's flash-decode launches."""
    cfg = model.cfg
    L, nps = cfg.n_layers, norms_per_step(cfg)
    runs = [("dense, chunked", "bf16", dict(paged=False)),
            ("dense, monolithic", "bf16", dict(paged=False, prefill_chunk=0)),
            ("paged bf16, monolithic", "bf16", dict(prefill_chunk=0)),
            ("paged int8, monolithic", "int8", dict(prefill_chunk=0))]
    out, got = {}, {}
    for label, kv_dtype, kw in runs:
        eng, reqs = _warm_engine(model, params, kv_dtype, **kw)
        wall, counts, st = _drive(eng, reqs)
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        prefills, sfx = st["prefills"], st["suffix_prefills"]
        want = {n: 0 for n in WRAPPERS}
        want["rmsnorm"] = nps * (steps + chunks + prefills)
        want["flash_attention"] = L * prefills
        q = "_quant" if kv_dtype == "int8" else ""
        decode = "flash_decode" if not eng.paged else f"paged_decode{q}"
        want[decode] = L * steps
        check(counts == want, f"{label} launched {counts}, want {want} "
              f"({steps} decode steps, {chunks} prefill chunks, {prefills} "
              f"monolithic prefills)")
        check(eng.chunked == (chunks > 0 and prefills == 0),
              f"{label}: {chunks} chunks, {prefills} monolithic prefills")
        if eng.paged:
            check(sfx > 0 and st["prefix_hits"] > 0,
                  f"{label}: no prefill_with_prefix ({sfx}) or prefix hit")
        got[label] = [tuple(r.output) for r in reqs]
        if label == "dense, chunked":
            out["flash_decode"] = counts["flash_decode"]
        same = sum(a == b for a, b in zip(got[label], streams[kv_dtype]))
        print(f"[dense] {label}: 12 requests, prompts "
              f"{sum(len(r.tokens) for r in reqs)} tokens "
              f"({st['prefix_tokens_reused']} reused) in {chunks} prefill "
              f"chunks and {prefills} monolithic prefills ({sfx} against a "
              f"cached prefix), {st['decode_tokens']} decode tokens in "
              f"{steps} decode steps, {wall:.3f} s wall; "
              f"{_latency_line(st, wall)}; streams equal to the paged "
              f"chunked {kv_dtype} run (phase 5): {same} of {len(reqs)}; "
              f"launches: {decode} {want[decode]} = {L} x {steps}, "
              f"flash_attention {want['flash_attention']} = {L} x "
              f"{prefills}, rmsnorm {want['rmsnorm']} = {nps} x ({steps} + "
              f"{chunks} + {prefills}) ({smi})")
    mono = got["dense, monolithic"]
    same = [sum(a == b for a, b in zip(got[other], mono))
            for other in ("dense, chunked", "paged bf16, monolithic")]
    print(f"[dense] streams equal to the dense monolithic run: dense chunked "
          f"{same[0]} of 12, paged bf16 monolithic {same[1]} of 12 (bf16 "
          f"near-ties may flip; identity is held in fp32 at reduced size, "
          f"phase 10)")
    return out


def phase_profile(model, params, smi: str):
    """Where the time goes, over short windows: engine steps PROFILE_SKIP
    .. PROFILE_SKIP + PROFILE_STEPS of the bf16 main path (paged, prefill
    chunks and decode ticks) and of phase 8's dense chunked engine (its
    decode ticks attend through flash decode), each run once plainly for
    the wall time and once more, the same steps, with the engine's trace
    spans and torch.profiler on.  The idle share is the profiled kernels'
    device time against the plain run's wall time."""
    for label, kw in (("bf16 main path", {}),
                      ("dense chunked", dict(paged=False))):
        _profile_window(model, params, label, kw, smi)


def _profile_window(model, params, label, kw, smi: str):
    """One profiled window of ``phase_profile``: an engine made with the
    keywords ``kw``; prints its busy share, span totals, top kernels and
    the device time and launches of the decode, verify, flash-attention
    and RMSNorm kernels."""

    def window(telemetry, profiler):
        eng, reqs = _warm_engine(model, params, "bf16", telemetry, **kw)
        for r in reqs:
            eng.submit(r)
        for _ in range(PROFILE_SKIP):
            eng.step()
        torch.cuda.synchronize()
        if telemetry is not None:
            telemetry.tracer.clear()
        for w in WRAPPERS.values():
            w.launches = 0
        with profiler:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return wall, {n: w.launches for n, w in WRAPPERS.items()}

    wall, _ = window(None, contextlib.nullcontext())
    tel = Telemetry(trace=True)
    # device activity only: the kernels' device time is all that is read
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    pwall, calls = window(tel, prof)
    spans: dict = {}
    for ev in tel.tracer.events:
        if ev.get("ph") == "X" and ev["cat"] in ("engine", "prefill"):
            n, t = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, t + ev["dur"] / 1e6)
    check(spans.get("decode_tick", (0,))[0] > 0,
          f"the profiled window ran no decode tick: {spans}")
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    print(f"[profile] {label}, engine steps {PROFILE_SKIP}.."
          f"{PROFILE_SKIP + PROFILE_STEPS}: wall {wall:.4f} s (under "
          f"torch.profiler {pwall:.4f} s); device busy {busy:.4f} s = "
          f"{busy / wall:.1%} of the plain wall, idle {1 - busy / wall:.1%}"
          f" ({smi})")
    print(f"[profile] {label}: engine spans (host wall clock, profiled "
          "run): " + "; ".join(f"{name} {n} x, {t:.4f} s"
                               for name, (n, t) in sorted(spans.items())))
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")
    groups = (
        ("paged decode (its scores and values kernels)", "paged_decode",
         lambda k: ("decode_split" in k and "DenseKeys" not in k)
         or "paged_decode_kernel" in k),
        ("paged verify (its scores, values and combine kernels)",
         "paged_verify", lambda k: "verify_split" in k
         or "verify_combine" in k),
        ("flash decode (its kernels)", "flash_decode",
         lambda k: "DenseKeys" in k or "flash_decode_kernel" in k),
        ("flash attention (every instantiation)", "flash_attention",
         lambda k: "flash_fp32" in k or "flash_attention_" in k),
        ("RMSNorm", "rmsnorm", lambda k: "rmsnorm_kernel" in k),
        ("SSD scan (its passes)", "ssd_scan", lambda k: "ssd_" in k))
    for what, name, match in groups:
        sel = [e for e in kernels if match(e.key)]
        print(f"[profile] {label}: {what}: "
              f"{sum(dev_us(e) for e in sel) / 1e3:.3f} ms of device time, "
              f"{sum(e.count for e in sel)} kernel launches, {calls[name]} "
              "wrapper calls")


def moe_model():
    """granite-moe-1b-a400m at full width and depth (24 layers, d 1024,
    32 experts of 512, top-8), random bf16 weights from seed 0, on the
    card."""
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"[moe] {MOE_ARCH} full width: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_experts} experts of {cfg.moe_ff} (top "
          f"{cfg.top_k}), vocab {cfg.vocab}, {n / 1e9:.3f} B parameters, "
          f"bf16 weights drawn on the card from seed 0 in "
          f"{time.perf_counter() - t0:.2f} s")
    return model, params


def phase_moe(model, params, smi: str) -> dict:
    """The MoE family at full width: the 12 text requests of phase 5
    (granite's vocab) through a paged engine with chunked prefill (bf16 and
    int8 pools), a paged engine with monolithic prefill, a dense engine
    with chunked prefill, and a paged bf16 engine with spec_k=3 drafted by
    a 4-layer cut of the target (an MoE draft).  Launches must be exactly:
    grouped_matmul = 3 x n_layers x (decode steps + prefill chunks +
    monolithic prefills + verify passes) + 3 x draft layers x (draft
    prefills + draft steps); the attention kernels and RMSNorm as phases
    5-8 count them.  Returns each run's grouped_matmul launches."""
    cfg = model.cfg
    L, nps = cfg.n_layers, norms_per_step(cfg)
    dcfg, dparams = _cut_draft(cfg, params, MOE_DRAFT_LAYERS)
    Ld = dcfg.n_layers
    runs = [("paged bf16, chunked", "bf16", {}),
            ("paged int8, chunked", "int8", {}),
            ("paged bf16, monolithic", "bf16", dict(prefill_chunk=0)),
            ("dense, chunked", "bf16", dict(paged=False)),
            (f"paged bf16, spec_k={SPEC_K}, {Ld}-layer draft", "bf16",
             dict(draft_config=dcfg, draft_params=dparams, spec_k=SPEC_K))]
    out = {}
    for label, kv_dtype, kw in runs:
        eng, reqs = _warm_engine(model, params, kv_dtype, **kw)
        wall, counts, st = _drive(eng, reqs)
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        prefills, ticks = st["prefills"], st["verify_steps"]
        installs, dsteps = st["draft_prefills"], st["draft_steps"]
        passes = steps + chunks + prefills + ticks
        q = "_quant" if kv_dtype == "int8" else ""
        want = {n: 0 for n in WRAPPERS}
        want["grouped_matmul"] = 3 * L * passes + 3 * Ld * (installs
                                                            + dsteps)
        want["rmsnorm"] = nps * passes + norms_per_step(dcfg) * (installs
                                                                 + dsteps)
        want["flash_attention"] = L * prefills + Ld * installs
        want["flash_decode"] = Ld * dsteps
        if eng.paged:
            want[f"paged_decode{q}"] = L * steps
            want[f"paged_verify{q}"] = L * (chunks + ticks)
        else:  # dense chunks attend through the plain version
            want["flash_decode"] = L * steps
        check(counts == want, f"{MOE_ARCH} {label} launched {counts}, want "
              f"{want} ({steps} decode steps, {chunks} prefill chunks, "
              f"{prefills} monolithic prefills, {ticks} verify passes, "
              f"{installs} draft prefills, {dsteps} draft steps)")
        check(bool(kw.get("spec_k")) == (ticks > 0 and steps == 0),
              f"{label}: {steps} decode steps, {ticks} verify passes")
        out[label] = counts["grouped_matmul"]
        extra = (f"; acceptance {eng.acceptance_rate():.3f}, "
                 f"{st['decode_tokens'] / ticks:.2f} tokens per verify pass"
                 if ticks else "")
        print(f"[moe] {label}: 12 requests, prompts "
              f"{sum(len(r.tokens) for r in reqs)} tokens "
              f"({st['prefix_tokens_reused']} reused) in {chunks} prefill "
              f"chunks and {prefills} monolithic prefills, "
              f"{st['decode_tokens']} decode tokens in {steps} decode steps "
              f"and {ticks} verify passes, {wall:.3f} s wall; "
              f"{_latency_line(st, wall)}{extra}; launches: grouped_matmul "
              f"{want['grouped_matmul']} = 3 x {L} x ({steps} + {chunks} + "
              f"{prefills} + {ticks}) + 3 x {Ld} x ({installs} + {dsteps}), "
              + ", ".join(f"{n} {c}" for n, c in counts.items()
                          if c and n != "grouped_matmul") + f" ({smi})")
    return out


def hybrid_model():
    """zamba2-2.7b at full width and depth, random bf16 weights drawn on
    the card from seed 0."""
    cfg = get_config(HYBRID_ARCH)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    G, P = lm.zamba2_groups(cfg)
    print(f"[hybrid] {HYBRID_ARCH} full width and depth: {cfg.n_layers} "
          f"Mamba2 layers in {G} groups of {P}, d {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, {cfg.d_inner // cfg.ssm_headdim} SSM heads of "
          f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv width "
          f"{cfg.conv_width}; one shared attention+MLP block ({cfg.n_heads} "
          f"heads of {cfg.hd}, d_ff {cfg.d_ff}) after each group; vocab "
          f"{cfg.vocab}; {n / 1e9:.3f} B parameters, {nbytes / 1e9:.2f} GB "
          f"in bf16, drawn on the card from seed 0 in {secs:.2f} s")
    return model, params


def hybrid_prompts(vocab):
    """12 prompts of 1-768 tokens that obey the prompt-length rule (any
    length up to scan_chunk 256, past it whole chunks): a 1-token prompt,
    lengths 37-256, and 512 and 768; four of them share a 200-token
    prefix."""
    rng = np.random.default_rng(12)
    shared = rng.integers(0, vocab, 200)
    tails = {0: 56, 2: 312, 4: 568, 7: 56}  # 256, 512, 768, 256 tokens
    lengths = [0, 37, 0, 1, 0, 130, 256, 0, 512, 64, 200, 768]
    return [np.concatenate([shared, rng.integers(0, vocab, tails[i])])
            if i in tails else rng.integers(0, vocab, m)
            for i, m in enumerate(lengths)]


def phase_hybrid(model, params, smi: str) -> int:
    """The hybrid family at full width: zamba2-2.7b serves 12 text
    requests (``hybrid_prompts``, 32 new tokens each) through
    ``ServingEngine(max_batch=8, max_seq=1024)``, which takes the dense
    backend and exact-shape monolithic prefill for it.  Launches must be
    exactly: ssd_scan = Mamba2 layers x prefills; flash attention = groups
    x prefills; flash decode = groups x decode steps; RMSNorm = (2 per
    Mamba2 layer + 2 per shared block + the final norm) x (prefills +
    decode steps); nothing else.  A 300-token prompt (past scan_chunk 256,
    not a multiple of it) is refused at submission with the prompt-length
    ValueError.  Returns the run's ssd_scan launches."""
    cfg = model.cfg
    L, (G, P) = cfg.n_layers, lm.zamba2_groups(cfg)
    nps = 2 * L + 2 * G + 1
    eng = _engine(model, params, "bf16")
    refused = ""
    try:
        eng.submit(Request(-2, np.arange(300) % cfg.vocab, max_new_tokens=4))
    except ValueError as e:
        refused = str(e)
    check("multiple" in refused and not eng.busy(),
          f"a 300-token prompt was not refused by the prompt-length rule: "
          f"{refused!r}")
    print(f"[hybrid] a 300-token prompt is refused at submission: "
          f"ValueError: {refused}")
    reqs = [Request(i, pr, max_new_tokens=32)
            for i, pr in enumerate(hybrid_prompts(cfg.vocab))]
    wall, counts, st = _drive(eng, reqs)
    prefills, steps = st["prefills"], st["decode_steps"]
    want = {n: 0 for n in WRAPPERS}
    want["ssd_scan"] = L * prefills
    want["flash_attention"] = G * prefills
    want["flash_decode"] = G * steps
    want["rmsnorm"] = nps * (prefills + steps)
    check(counts == want, f"{HYBRID_ARCH} launched {counts}, want {want} "
          f"({prefills} prefills, {steps} decode steps)")
    check(not st["paged"] and not st["chunked"] and not st["bucketed"]
          and prefills == len(reqs) and st["prefill_chunks"] == 0,
          f"{HYBRID_ARCH}: paged {st['paged']}, chunked {st['chunked']}, "
          f"{prefills} prefills, {st['prefill_chunks']} chunks")
    sizes = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]} "
                      f"{v.numel() * v.element_size() / 1e6:.1f} MB"
                      for k, v in eng.cache.items())
    print(f"[hybrid] dense cache at {eng.max_batch} slots, max_seq "
          f"{eng.max_seq}: {sizes}")
    print(f"[hybrid] dense backend, monolithic exact-shape prefill: 12 "
          f"requests, prompts {sum(len(r.tokens) for r in reqs)} tokens "
          f"(lengths {[len(r.tokens) for r in reqs]}) in {prefills} "
          f"prefills, {st['decode_tokens']} decode tokens in {steps} decode "
          f"steps, {wall:.3f} s wall; {_latency_line(st, wall)}; launches: "
          f"ssd_scan {want['ssd_scan']} = {L} x {prefills}, flash_attention "
          f"{want['flash_attention']} = {G} x {prefills}, flash_decode "
          f"{want['flash_decode']} = {G} x {steps}, rmsnorm "
          f"{want['rmsnorm']} = {nps} x ({prefills} + {steps}) ({smi})")
    return counts["ssd_scan"]


def phase_hybrid_profile(model, params, smi: str):
    """One monolithic prefill of phase 9c's 768-token prompt
    (``hybrid_prompts``; one new token) under ``torch.profiler`` (device
    activity only), after the same request once plainly to warm its
    shapes: the device busy time, and the SSD scan's device time, kernel
    launches, wrapper calls (one per Mamba2 layer) and share of the busy
    time."""
    cfg = model.cfg
    prompt = max(hybrid_prompts(cfg.vocab), key=len)
    eng = _engine(model, params, "bf16")

    def prefill(uid):
        eng.reset_prefix_cache()
        r = Request(uid, prompt, max_new_tokens=1)
        eng.submit(r)
        eng.run_until_drained()
        torch.cuda.synchronize()
        check(r.done and len(r.output) == 1, f"prefill {uid}: {r.output}")

    prefill(-3)
    for w in WRAPPERS.values():
        w.launches = 0
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        prefill(-4)
        wall = time.perf_counter() - t0
    calls = scan_kernel.ssd_scan.launches
    check(calls == cfg.n_layers, f"the profiled prefill made {calls} "
          f"ssd_scan calls, want {cfg.n_layers}")
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    check(busy > 0, "the profiler saw no device time")
    scan = [e for e in kernels if "ssd_" in e.key]
    scan_ms = sum(dev_us(e) for e in scan) / 1e3
    print(f"[hybrid] profile of one monolithic prefill of {len(prompt)} "
          f"tokens: wall {wall * 1e3:.2f} ms under torch.profiler, device "
          f"busy {busy:.3f} ms; SSD scan {scan_ms:.3f} ms of device time "
          f"({scan_ms / busy:.1%} of busy), {sum(e.count for e in scan)} "
          f"kernel launches, {calls} wrapper calls ({smi})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[hybrid]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")


def hybrid_parity():
    """Reduced zamba2-2.7b in fp32 with scan_chunk 16: 10 text prompts of
    1-64 tokens that obey the prompt-length rule (several chunks; two
    share a 16-token prefix) through the dense backend with monolithic
    prefill, on the CPU (plain versions) and on the card (kernels):
    identical tokens."""
    cfg = reduced(get_config(HYBRID_ARCH), act_dtype="float32", scan_chunk=16)
    model = build_model(cfg)
    cpu_params = model.init(0, param_dtype=torch.float32, device="cpu")
    gpu_params = _tree_map(lambda t: t.to("cuda"), cpu_params)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [rng.integers(0, cfg.vocab, n)
               for n in (1, 6, 16, 32, 48, 9, 64, 13)]
    prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab, 16)])
                for _ in range(2)]

    def serve(dev, params):
        eng = ServingEngine(model, params, max_batch=3, max_seq=128,
                            device=dev)
        reqs = [Request(i, pr, max_new_tokens=8)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        check(not eng.paged and not eng.chunked,
              f"reduced {HYBRID_ARCH} {dev}: paged {eng.paged}, chunked "
              f"{eng.chunked}")
        return [tuple(r.output) for r in reqs]

    cpu, cuda = serve("cpu", cpu_params), serve("cuda", gpu_params)
    check(cpu == cuda, f"reduced {HYBRID_ARCH}: CPU and CUDA engines "
          f"disagree:\n{cpu}\n{cuda}")
    print(f"[parity] reduced {HYBRID_ARCH} fp32, scan_chunk 16, dense "
          f"monolithic engine: CPU (plain) and CUDA (kernels) engines give "
          f"identical tokens for {len(prompts)} text requests of "
          f"{sorted({len(pr) for pr in prompts})} tokens")


def reduced_mm_features(d_model) -> dict:
    """Media features at reduced width: a 2-layer, two-head encoder of
    ``d_model`` (fp32, seed 17) on the card and on the CPU, which must
    agree (1e-4 absolute on rows of RMS ~1: fp32 matmuls summed in other
    orders) and keep the same positions.  The final norm's scale is drawn
    from N(1, 0.5^2): at the init's unit scale every row has the L2 norm
    sqrt(d) up to rounding, and keep-top-k would rank by rounding noise.
    Returns the card's features."""
    cfg = enc.MMEncoderConfig(d_model=d_model, keep_ratio=1 / 3)
    cpu = enc.init_mm_encoder(cfg, ENC_SEED, device="cpu")
    cpu["final"]["scale"] = torch.from_numpy(
        np.random.default_rng(4).normal(1.0, 0.5, d_model)).float()
    gpu = _tree_map(lambda t: t.to("cuda"), cpu)
    media = mm_media()
    feats = {}
    for key, fn in (("small", enc.encode_image), ("large", enc.encode_image),
                    ("audio", enc.encode_audio)):
        x = torch.from_numpy(media[key])
        got = fn(cfg, gpu, x.to("cuda")).cpu()
        want = fn(cfg, cpu, x)
        err = float((got - want).abs().max())
        check(got.shape == want.shape and err <= 1e-4,
              f"reduced encoder {key}: card and CPU differ by {err}")
        feats[key] = got.numpy()
    return feats


def phase_reduced_parity():
    """fp32 at reduced size, where greedy tokens are sound to compare: the
    CPU engine (plain versions) and the CUDA engine (kernels) agree on
    each variant a config of PARITY serves (VARIANTS: paged chunked bf16
    and int8, each plain and speculative with a self-draft at spec_k=3,
    dense chunked and monolithic, paged monolithic bf16 and int8), and
    for the dense configs speculation on the card gives the tokens of
    plain decode; for text requests and for 12 multimodal requests
    (features from the reduced encoder, which must give the CPU's
    features on the card)."""
    for arch, over, max_batch, variants in PARITY:
        cfg = reduced(get_config(arch), act_dtype="float32", **over)
        model = build_model(cfg)
        arch = cfg.name.removesuffix("-reduced") + "".join(
            f", {k} {v}" for k, v in over.items()) + (
            f", max_batch {max_batch}" if max_batch != 3 else "")
        cpu_params = model.init(0, param_dtype=torch.float32, device="cpu")
        gpu_params = _tree_map(lambda t: t.to("cuda"), cpu_params)
        rng = np.random.default_rng(2)
        shared = rng.integers(0, cfg.vocab, 24)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (6, 21, 33, 9, 50)]
        prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab, 5)])
                    for _ in range(3)]
        feats = reduced_mm_features(cfg.d_model)

        def serve(dev, params, spec, **kw):
            if spec:
                kw.update(draft_config=cfg, draft_params=params,
                          spec_k=SPEC_K)
            eng = ServingEngine(model, params, max_batch=max_batch,
                                max_seq=128,
                                device=dev, **{**dict(
                                    page_size=8, prefill_chunk=16), **kw})
            reqs = [Request(i, p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            reqs += mm_requests(cfg.vocab, feats, new_tokens=8,
                                heads=(3, 9), tails=(4, 17))
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            check(eng.prefix_tokens_reused > 0 or not eng.paged,
                  f"{arch} {kw} {dev}: no prefix reuse")
            return [tuple(r.output) for r in reqs]

        cuda = {}
        for label in variants:
            kw, spec = VARIANTS[label]
            cpu = serve("cpu", cpu_params, spec, **kw)
            cuda[label] = serve("cuda", gpu_params, spec, **kw)
            check(cpu == cuda[label], f"{arch} {label}: CPU and CUDA "
                  f"engines disagree:\n{cpu}\n{cuda[label]}")
            print(f"[parity] reduced {arch} fp32, {label} engine: CPU "
                  f"(plain) and CUDA (kernels) engines give identical tokens "
                  f"for {len(prompts)} text and {len(MM_ORDER)} multimodal "
                  f"requests")
        # an MoE layer's capacity and drops depend on the tokens of the
        # call, which a verify pass batches differently from a decode tick:
        # speculation need not give plain decode's tokens there, in the JAX
        # package as here
        for pool in ("bf16", "int8"):
            if pool in cuda and f"{pool} spec" in cuda:
                plain, spec = cuda[pool], cuda[f"{pool} spec"]
                same = sum(x == y for x, y in zip(plain, spec))
                check(bool(cfg.n_experts) or plain == spec,
                      f"{arch} {pool}: CUDA plain and speculative engines "
                      f"disagree:\n{plain}\n{spec}")
                print(f"[parity] reduced {arch} fp32, {pool} pool: on the "
                      f"card speculation gives the tokens of plain decode "
                      f"for {same} of {len(plain)} requests"
                      f"{'' if cfg.n_experts else ' (held)'}; the reduced "
                      f"encoder (d {cfg.d_model}) gives the CPU's features "
                      f"on the card")


def analytic_predictors(bench):
    """fig10's idealized MILP/MGQP (benchmarks/fig10_continuum_replay.py:62,
    a numpy copy: this script imports nothing of the JAX package): the
    cost model evaluated without noise, [n_tasks, n_classes] latency
    estimates and success probabilities."""
    C = len(SERVER_CLASSES)
    aff = cm.category_affinity(len(CATEGORIES), C)
    t_hat = np.zeros((bench.tasks.n, C))
    b_hat = np.zeros((bench.tasks.n, C))
    for c, (dev, mdl) in enumerate(SERVER_CLASSES):
        t_hat[:, c] = cm.latency_s(cm.DEVICES[dev], cm.MODELS[mdl],
                                   bench.tasks.text_len,
                                   bench.tasks.difficulty)
        b_hat[:, c] = cm.success_prob(cm.MODELS[mdl], bench.tasks.difficulty,
                                      aff[bench.tasks.category, c])
    return t_hat, b_hat


def qlmio_policy(t_hat, b_hat, servers, w):
    """fig10's QLMIO scoring rule (router Eq. 21 shape) over episode state
    (benchmarks/fig10_continuum_replay.py:79, a numpy copy)."""
    cls = servers.cls

    def policy(ep):
        total = t_hat[ep.current_task, cls] + ep.queue_s
        u = -total / max(total.min(), 1e-6) + w * (
            3.0 * b_hat[ep.current_task, cls] - 2.0)
        return int(np.argmax(u))

    return policy


def recorded(policy, picks: list):
    """``policy``, appending each decision to ``picks``."""
    def wrapped(ep):
        picks.append(policy(ep))
        return picks[-1]

    return wrapped


def fleet_launches(handles) -> dict:
    """The kernel launches the handles' engine steps imply, summed over
    the fleet, as phases 5 and 8 count them: paged decode n_layers a decode
    step and paged verify n_layers a prefill chunk, each in its pool's
    instance, flash attention n_layers a monolithic prefill, RMSNorm the
    norms of every step, chunk and prefill."""
    want = {n: 0 for n in WRAPPERS}
    for h in handles:
        cfg, st = h.cfg, h.engine.stats()
        steps, chunks = st["decode_steps"], st["prefill_chunks"]
        prefills = st["prefills"]
        check(st["verify_steps"] == 0,
              f"{h.name}: {st['verify_steps']} verify passes")
        q = "_quant" if h.kv_dtype == "int8" else ""
        want[f"paged_decode{q}"] += cfg.n_layers * steps
        want[f"paged_verify{q}"] += cfg.n_layers * chunks
        want["flash_attention"] += cfg.n_layers * prefills
        want["rmsnorm"] += norms_per_step(cfg) * (steps + chunks + prefills)
    return want


def replay(cluster, bench, servers, tasks, policy) -> dict:
    """One fig10 replay (benchmarks/fig10_continuum_replay.py:128-141)
    with every launch count set to 0 just before and read just after:
    run_policy's aggregates, the per-server requests, tokens, charged
    engine steps, the wall seconds, the launches and what the fleet's
    steps imply.  Every request must finish with its full budget of
    in-vocabulary tokens."""
    cluster.reset()
    gc.collect()
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backend = EngineBackend(cluster, bench, servers,
                            arrival_dt=CONTINUUM_ARRIVAL_DT)
    out = run_policy(policy, bench, servers, tasks,
                     np.random.default_rng(1), backend=backend)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {n: w.launches for n, w in WRAPPERS.items()}
    handles = cluster.handles
    out["want"] = fleet_launches(handles)
    out["per_server_requests"] = [
        h.engine.latency_stats()["n_requests"] for h in handles]
    out["tokens_generated"] = sum(len(r.output) for h in handles
                                  for r in h.engine.finished)
    out["handle_steps"] = cluster.handle_steps
    out["decode_steps"] = sum(h.engine.stats()["decode_steps"]
                              for h in handles)
    out["prefill_chunks"] = sum(h.engine.stats()["prefill_chunks"]
                                for h in handles)
    recs = cluster.collect()
    check(len(recs) == len(tasks), f"{len(recs)} records of {len(tasks)}")
    for rec in recs:
        req = cluster.records[rec["uid"]]["req"]
        vocab = handles[rec["server"]].cfg.vocab
        check(req.done and len(req.output) == req.max_new_tokens
              and not rec["timeout"],
              f"request {rec['uid']} on server {rec['server']}: "
              f"{len(req.output)} of {req.max_new_tokens} tokens, "
              f"timeout {rec['timeout']}")
        check(all(0 <= t < vocab for t in req.output),
              f"request {rec['uid']}: token id out of range")
    return out


def continuum_fleet():
    """fig10's continuum (CONTINUUM_SPEC) at full width and depth on the
    card: one cloud llama3.2-3b (bf16 pool) and two edge qwen2-0.5b (int8
    pools), weights drawn on the card from seeds 0, 1 and 2, the handles'
    own settings (max_batch 2, max_seq 96, page 16, prefill_chunk 64)."""
    configs = {a: get_config(a) for a in CLASS_ARCHS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = build_continuum(CONTINUUM_SPEC, seed=0, configs=configs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for h in handles:
        e, cfg = h.engine, h.cfg
        n = sum(t.numel() for t in _leaves(e.params))
        print(f"[continuum] {h.name}: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.hd}, vocab {cfg.vocab}, {n / 1e9:.3f} B parameters in "
              f"bf16; {h.kv_dtype} pool of {e.pool.num_pages} pages of "
              f"{e.page_size}, max_batch {e.max_batch}, max_seq "
              f"{e.max_seq}, prefill_chunk {e.prefill_chunk}; profiled "
              f"decode tick {h.decode_tick_s * 1e3:.3f} ms, prefill "
              f"{h.prefill_tok_s * 1e6:.3f} us a token (virtual)")
    print(f"[continuum] fleet built with seeded weights drawn on the card "
          f"in {secs:.2f} s")
    return handles


def phase_continuum(smi: str):
    """fig10's smoke budget replayed over live full-width engines on the
    card under all-cloud, greedy and fig10's QLMIO rule at quality weight
    1.0.  Checks: every request gets its full budget; QLMIO's mean e2e is
    below all-cloud's at a completion rate of at least 0.95 x its; the
    greedy policy's decisions equal its decisions under the cost-model
    backend; each kernel's launches equal what the fleet's steps
    imply."""
    handles = continuum_fleet()
    cluster = Cluster(handles)
    # one short request per handle first, so no replay pays the first
    # cuBLAS calls (cluster.reset() then clears the metrics and tries)
    for s, h in enumerate(handles):
        cluster.submit(ContinuumRequest(tokens=np.arange(1, 30),
                                        max_new_tokens=3, task=s, server=s))
    cluster.drain()
    bench = generate(seed=0, n_tasks=CONTINUUM_TASKS)
    servers = make_servers_from_spec(CONTINUUM_SPEC, bench)
    t_hat, b_hat = analytic_predictors(bench)
    tasks = np.random.default_rng(0).choice(bench.tasks.n, CONTINUUM_USERS,
                                            replace=False)
    results = {}
    for name, policy in [
            ("all_cloud", all_cloud_policy(servers)),
            ("greedy", greedy_policy()),
            ("qlmio", qlmio_policy(t_hat, b_hat, servers, 1.0))]:
        picks, cost_picks = [], []
        r = replay(cluster, bench, servers, tasks, recorded(policy, picks))
        run_policy(recorded(policy, cost_picks), bench, servers, tasks,
                   np.random.default_rng(1))
        check(picks == cost_picks, f"{name}: decisions under the engine "
              f"backend {picks} differ from the cost-model backend's "
              f"{cost_picks}")
        check(r["launches"] == r["want"], f"{name} replay launched "
              f"{r['launches']}, the fleet's steps imply {r['want']}")
        results[name] = r
        print(f"[continuum] {name}: avg e2e {r['avg_latency_s']:.4f} s, p95 "
              f"e2e {r['p95_latency_s']:.4f} s, avg TTFT "
              f"{r['avg_ttft_s']:.4f} s (virtual), completion "
              f"{r['completion_rate']:.4f}; per-server requests "
              f"{r['per_server_requests']}, {r['tokens_generated']} tokens, "
              f"{r['handle_steps']} engine steps ({r['decode_steps']} decode "
              f"steps, {r['prefill_chunks']} prefill chunks); decisions = "
              f"the cost-model backend's; replay {r['wall_s']:.3f} s wall on "
              f"the card; launches " + ", ".join(
                  f"{n} {c}" for n, c in r["launches"].items() if c)
              + f" = the fleet's steps ({smi})")
    q, ac = results["qlmio"], results["all_cloud"]
    red = 1.0 - q["avg_latency_s"] / ac["avg_latency_s"]
    comp = q["completion_rate"] / max(ac["completion_rate"], 1e-9)
    check(q["avg_latency_s"] < ac["avg_latency_s"],
          f"QLMIO {q['avg_latency_s']:.4f} s is not below all-cloud "
          f"{ac['avg_latency_s']:.4f} s")
    check(comp >= 0.95, f"QLMIO's completion is {comp:.4f} x all-cloud's")
    print(f"[continuum] QLMIO vs all-cloud: mean e2e {red:.1%} lower, "
          f"completion {comp:.4f} x ({CONTINUUM_USERS} users of "
          f"generate(0, {CONTINUUM_TASKS}), arrival_dt "
          f"{CONTINUUM_ARRIVAL_DT}) ({smi})")
    del cluster, handles
    gc.collect()
    torch.cuda.empty_cache()


def twin_cluster(params, cfg, kv_dtypes, chunk) -> Cluster:
    """Two cloud-class handles of ``cfg`` sharing ``params`` (the KV- and
    weight-compatible pair fig12 migrates between), with the given pools
    and prefill chunk."""
    dev, prof = SERVER_CLASSES[-1]
    return Cluster([EngineHandle(
        f"twin-{i} ({kv})", cfg.name, cm.DEVICES[dev], cm.MODELS[prof],
        is_cloud=True, config=cfg, params=params, kv_dtype=kv,
        prefill_chunk=chunk) for i, kv in enumerate(kv_dtypes)])


def phase_migration(smi: str):
    """Decode-phase migration between two full-width qwen2-0.5b handles
    on the card (``Cluster.migrate`` after MIGRATE_AFTER tokens) for
    bf16 -> bf16 and int8 -> int8 pools with chunked and monolithic
    prefill: the tokens must equal the single-engine run's, the
    destination runs no prefill pass, and the export/import page counters
    and bytes equal pages x page_bytes().  bf16 -> int8 and int8 -> bf16
    must serve the full budget; their agreement with the unmigrated
    stream is printed."""
    cfg = get_config("qwen2-0.5b")
    params = build_model(cfg).init(0, device="cuda")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, n) for n in (40, 48, 21)]
    cases = [(("bf16", "bf16"), 64), (("bf16", "bf16"), 0),
             (("int8", "int8"), 64), (("int8", "int8"), 0),
             (("bf16", "int8"), 64), (("int8", "bf16"), 64)]
    for kv_dtypes, chunk in cases:
        cl = twin_cluster(params, cfg, kv_dtypes, chunk)
        src, dst = cl.handles
        for prompt in prompts:
            cl.reset()
            uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=10,
                                             task=0, server=0))
            cl.drain()
            base = cl.records[uid]["req"].output
            cl.reset()
            for w in WRAPPERS.values():
                w.launches = 0
            uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=10,
                                             task=0, server=0))
            req = cl.records[uid]["req"]
            while len(req.output) < MIGRATE_AFTER:
                cl.advance_to(cl.t + src.decode_tick_s)
            j = len(req.output)
            move = cl.migrate(uid, 1)
            cl.drain()
            rec = cl.collect()[0]
            counts = {n: w.launches for n, w in WRAPPERS.items()}
            want = fleet_launches(cl.handles)
            check(counts == want, f"migration {kv_dtypes} launched "
                  f"{counts}, the steps imply {want}")
            s_st, d_st = src.engine.stats(), dst.engine.stats()
            n_ctx = len(prompt) + j - 1
            pages = -(-n_ctx // dst.engine.page_size)
            check(req.done and len(req.output) == 10 and not rec["timeout"]
                  and rec["server"] == 1,
                  f"migrated request: {len(req.output)} tokens, server "
                  f"{rec['server']}")
            check(d_st["prefill_chunks"] == d_st["prefills"] == 0
                  and d_st["prefill_tokens_computed"] == 0,
                  f"the destination ran a prefill pass: {d_st}")
            check(s_st["kv_exported_pages"] == d_st["kv_imported_pages"]
                  == move["pages"] == pages
                  and s_st["kv_export_bytes"]
                  == pages * src.engine.page_bytes()
                  and d_st["kv_import_bytes"] == move["bytes"]
                  == pages * dst.engine.page_bytes(),
                  f"page counters: exported {s_st['kv_exported_pages']} "
                  f"({s_st['kv_export_bytes']} B), imported "
                  f"{d_st['kv_imported_pages']} ({d_st['kv_import_bytes']} "
                  f"B), move {move}, want {pages} pages")
            same = sum(a == b for a, b in zip(req.output, base))
            exact = kv_dtypes[0] == kv_dtypes[1]
            if exact:
                check(req.output == base,
                      f"{kv_dtypes} chunk {chunk}: migrated {req.output} != "
                      f"single-engine {base}")
            print(f"[migrate] {kv_dtypes[0]} -> {kv_dtypes[1]}, prefill "
                  f"chunk {chunk or 'monolithic'}, prompt {len(prompt)}: "
                  f"moved after {j} tokens, {pages} pages, "
                  f"{s_st['kv_export_bytes']} B exported, "
                  f"{d_st['kv_import_bytes']} B imported, link "
                  f"{move['migrate_s'] * 1e3:.3f} ms (virtual); destination "
                  f"ran no prefill; {same}/10 tokens equal the unmigrated "
                  f"stream{' (checked)' if exact else ''}; "
                  f"e2e {rec['e2e_s']:.4f} s (virtual) ({smi})")
        del cl, src, dst
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def timed(label: str):
    """Prints the host seconds a phase took."""
    t0 = time.perf_counter()
    yield
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def decode_only(smi: str):
    """``--decode-only``: the paged kernels', flash decode's and the SSD
    scan's phase-4 rows and phase 9's two profiled windows, nothing else
    and no result line; run from a checkout whose ``src`` is another tree's (an older
    one's), it measures that tree's kernels with this script's shapes and
    windows."""
    phase_timing(np.random.default_rng(0), smi)
    _time_flash_decode(smi)
    _time_scan(smi)
    model, params = main_model()
    phase_profile(model, params, smi)


def main():
    t_start = time.perf_counter()
    # fp32 products in fp32 (no TF32), for the fp32 comparisons and parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    if sys.argv[1:] == ["--decode-only"]:
        decode_only(smi)
        print(f"[done] {time.perf_counter() - t_start:.1f} s (decode only, "
              "no result)")
        return
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    with timed("build"):
        phase_build()
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    with timed("compare"):
        worst = phase_compare(rng)
    with timed("timing"):
        timing = phase_timing(rng, smi)
        timing.update(phase_timing_new(smi))
    with timed("text path"):
        model, params = main_model()
        launches, streams = phase_main_path(model, params, smi)
    with timed("speculation"):
        spec_launches = phase_speculation(model, params, streams, smi)
    with timed("multimodal"):
        mm_launches = phase_multimodal(model, params, smi)
    with timed("dense and monolithic"):
        dense_launches = phase_dense(model, params, streams, smi)
    with timed("profile"):
        phase_profile(model, params, smi)
    del model, params
    with timed("MoE path"):
        moe, moe_params = moe_model()
        moe_launches = phase_moe(moe, moe_params, smi)
        del moe, moe_params
    with timed("hybrid path"):
        hybrid, hybrid_params = hybrid_model()
        hybrid_launches = phase_hybrid(hybrid, hybrid_params, smi)
        phase_hybrid_profile(hybrid, hybrid_params, smi)
        del hybrid, hybrid_params
    gc.collect()
    torch.cuda.empty_cache()
    with timed("continuum"):
        phase_continuum(smi)
        phase_migration(smi)
    with timed("reduced parity"):
        phase_reduced_parity()
        hybrid_parity()
    kernels = []
    for name in WRAPPERS:
        t = timing[name]
        # paged decode kernels: the text path's launches; verify kernels:
        # the speculative text path's (verify passes and prefill chunks);
        # flash attention and RMSNorm: the speculative multimodal path's
        # (encoder, draft prefills, every step's norms); flash decode: the
        # dense chunked run's (phase 8); its int8 instance: no serving path
        # launches it (every run above held its count to 0); the grouped
        # matmul: the MoE path's paged bf16 chunked run (phase 9b); the SSD
        # scan: the hybrid path's run (phase 9c)
        if name in ("flash_attention", "rmsnorm"):
            n = mm_launches[name]
        elif name == "flash_decode":
            n = dense_launches[name]
        elif name == "flash_decode_quant":
            n = 0
        elif name == "grouped_matmul":
            n = moe_launches["paged bf16, chunked"]
        elif name == "ssd_scan":
            n = hybrid_launches
        else:
            n = spec_launches.get(name, launches[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[SOURCE_OF.get(name,
                                            name.removesuffix("_quant"))],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": max(worst[name], t["main_shapes_max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # the device time alone (torch.profiler) of the kernel and of
            # the library call, where phase 4 took it (the SSD scan has no
            # library call)
            "device_ms": t.get("device_ms"),
            "library_device_ms": t.get("library_device_ms")})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
