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
     ``moe_gmm.cu``, ``ssd_scan.cu``, ``flash_attention_bwd.cu``,
     ``moe_gmm_bwd.cu`` and ``ssd_scan_bwd.cu`` for
     sm_90a, all nvcc runs at once
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
     the SSD scan's chunked passes, nor in the flash-attention backward
     (HMMA instructions in its SASS: the bf16 kernels' tensor-core
     products), whose passes' shared memory at every head dim in bf16 and
     fp32 and whose key-pass split plan (``bwd_plan``) at its phase-4
     shapes it prints beside the RMSNorm backward's plan, nor in the
     grouped-matmul backward (HMMA instructions in its SASS) or the
     SSD-scan backward, whose passes' shared memory and scratch at
     zamba2's width it prints);
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
     whose rows start below Sk - Sq against a cached prefix), and
     whisper-large-v3's 20 heads of 64 (its encoder's 1500 frames
     non-causal, the cross-attention of 1, 33 and 64 queries against
     them, the decoder's causal 64 tokens); the fused
     RMSNorm at a decode tick, a prefill chunk, the CPU tests' shapes and
     every width the port normalizes (896, 1024, 1152, 256, 3072, 2560,
     5120, xlstm-1.3b's 2048 and 4096) at rows 1, 8, 64, 768 and 1024,
     bf16 and fp32 x and scale,
     zero-centred or not; flash decode over bf16, fp32 and int8 caches
     with bf16 and fp32 queries at the CPU tests' cases, qwen2-0.5b's
     serving shape (B 8, max_seq 1024, contexts 60-1000, a parked slot),
     gemma3-1b's windowed layers, llama3.2-3b's heads, zamba2-2.7b's
     shared attention (B 8, max_seq 1024, D 80), the reduced configs'
     D 16 and whisper-large-v3's tick (B 8, 20 heads of 64: the 1500
     frames of the cross-attention, every one visible, and the 448-entry
     self-attention cache, ragged), and at the edges of its split kernel
     (a ragged last split, a
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
     and past one 64-column block); the training kernels
     (``phase_train_compare``): the flash-attention backward against its
     plain backward in bf16 and fp32 at qwen2-0.5b's heads (S 1024),
     llama3.2-3b's (24/8 of 128), gemma3-1b's local (window 512) and
     global layers (4/1 of 256), a ragged S, a suffix at a q_offset and
     the reduced configs' D 16, with the forward's lse against the plain
     version's; the RMSNorm backward at rows 1-8192 for widths 896, 1152,
     2048, 3072 and 256, zero-centred or not; the new families'
     backwards (``compare_family_backwards``): the grouped-matmul
     backward at granite-moe-1b-a400m's training capacity (C 2560, gate/up
     and down), qwen2-moe-a2.7b's expert shape and a small C, the SSD-scan
     backward at zamba2-2.7b's width over B 4 x 256 and 1024 tokens and a
     ragged block with a final-state gradient, the flash backward at D 80
     (zamba2's shared block, S 1024 and a ragged 999) and whisper's
     encoder (1500 frames), cross-attention (448 x 1500) and decoder; each
     within its stated fraction of the output's largest magnitude, two
     calls bit-equal; the new wrappers under sync debug mode "error";
  4. kernel, plain version and one library call's times at the main
     path's shapes (decode: B 8, B 1 at a 1000-token context, B 8 with
     two free slots; verify: the speculative B 8, T 4, the same with two
     free slots, and the prefill chunk B 1, T 64; the paged kernels and
     SDPA also by their device time alone, the split kernels' by pass;
     paged verify's tensor-core kernel at T = 1 on the decode shape, the
     alternative to paged decode's CUDA-core passes; flash attention:
     the encoder's batch at
     S 256, the draft's prefill buckets, zamba2-2.7b's shared attention
     at S 768 and whisper-large-v3's encoder (S 1500), cross-attention
     (Sq 64, Sk 1500) and decoder (S 64); RMSNorm: [8, 896], [64, 896],
     the encoder's [1024, 896] and xlstm-1.3b's [8, 2048], [8, 4096] and
     [768, 4096]; flash decode: the dense
     cache at B 8, max_seq 1024, one slot at a 1000-token context, B 8
     with two free slots, zamba2-2.7b's shared attention (B 8, 32/32
     heads of 80) and whisper-large-v3's tick (B 8, 20/20 heads of 64,
     the 1500-frame cross cache and the 448-entry self cache), also by
     device time per launch; grouped matmul: granite-moe's decode,
     verify, chunk and monolithic capacities and qwen2-moe's decode and
     C 88, against ``torch.bmm``; each flash-attention and grouped-matmul
     row names the instantiation that ran; the SSD
     scan at a zamba2 prefill of 256, 768 and 1024 tokens, also by device
     time and by pass, which no single PyTorch call computes; the
     flash-attention backward at qwen2-0.5b's training shape (B 8, S 1024;
     also by device time) and gemma3-1b's layers against SDPA's backward,
     the RMSNorm backward at [8192, 896] (also by device time), [8192,
     1152] and [32768, 256] against ``F.rms_norm``'s, and the forward
     kernel without and with its lse; the grouped-matmul forward at
     granite-moe's training C 2560; the grouped-matmul backward at C 2560
     (also by device time) and qwen2-moe's shape against the two
     ``torch.bmm`` calls of dx and dw, the SSD-scan backward at zamba2's B
     4 x S 1024 (also by device time) and S 256, which no PyTorch call
     computes, and the flash backward at zamba2's D 80 and whisper's
     encoder shape against SDPA's backward; then the bf16 flash backward
     at each of those shapes by device time beside the CUDA-core
     kernels it replaced (``flash_bwd_parent``), run in turn
     (parent, kernel, kernel, parent), with SDPA's backward),
     beside the least time the card could take,
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
  9e. the paper's learning pipeline (``core/``) on the card: the frozen
     ViT-B/16 and DistilBERT encoders at the "paper" profile (seeded
     weights drawn on the card) turn all 3,377 tasks of ``generate(0)``
     into features (finite, [3377, 768]; seconds, tasks a second, peak
     memory, the encoders' device time at one batch against the fp32
     bound); the same weights drawn on the CPU give the CPU's features on
     the card (8 tasks, 1e-4 of the RMS); MILP and MGQP train at
     benchmarks/common.py's "paper" budget (50 epochs, batch 256, the
     8:1:1 split; each loss falls, MGQP's train accuracy > 0.55, MILP's
     train MAE below the mean predictor's); the D3QN QLMIO agent trains
     on their predictions at examples/quickstart.py's budget (5 servers,
     120 episodes of 15 users) and is evaluated beside All-Cloud, Greedy
     and Random (printed only); tests/test_core.py's oracle run (40
     episodes of 10 users) beats Random and learns; one Predictor step
     and one D3QNAgent step on the card equal the CPU's from the same
     weights and batch; none of the port's kernels is launched;
  9f. the dense families at full width: xlstm-1.3b (48 blocks, 6 groups
     of 7 mLSTM and 1 sLSTM, d 2048, 3.61 B parameters drawn on the card
     from seed 0 in bf16) serves 8 requests of 1-768 tokens and
     whisper-large-v3 (32 encoder and 32 decoder layers, d 1280, 1.60 B
     parameters) 8 requests, each with its own 1500 encoder frames and a
     decoder prompt of 1-64 tokens, 32 new tokens each, through
     ``ServingEngine(max_batch=8)`` on the dense backend (xlstm: exact-
     shape monolithic prefill, max_seq 1024; whisper: bucketed monolithic
     prefill, max_seq 448); RMSNorm launches must equal xlstm's norms x
     (prefills + decode steps), flash attention (32 + 2 x 32) x whisper's
     prefills and flash decode 2 x 32 x its decode steps; xlstm refuses a
     300-token prompt at submission and a 2-token prompt at admission
     (ValueError); scripts/smoke_decode.py's consistency check
     (prefill(34) against prefill(33) + serve_step, 2e-2 of the largest
     |logit|) with bf16 and fp32 activations on the bf16 weights, held
     for both but xlstm's bf16 run, which is printed (the JAX package's
     own xlstm exceeds the bound in bf16); TTFT, ITL, decode tokens a
     second and peak memory; one
     prefill and one decode tick of each under ``torch.profiler`` (busy,
     idle share, top kernels), beside xlstm's mC state bytes;
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
     prefill gives the CPU engine's tokens on the card; so do reduced
     xlstm-1.3b (text prompts) and whisper-large-v3 (each request with its
     own frames) in fp32 on the dense backend with monolithic prefill;
     then (``train_parity``) reduced qwen2-0.5b and gemma3-1b in fp32,
     weights drawn on the CPU: the loss and every gradient leaf of the
     first step on the card within 1e-5 of each leaf's largest |g| of the
     CPU's, and the parameters after 3 AdamW steps within the Adam-aware
     bound, and so for reduced granite-moe-1b-a400m, qwen2-moe-a2.7b,
     zamba2-2.7b and xlstm-1.3b (scan_chunk 16) and whisper-large-v3;
     and (``hold_no_backward``) no serving phase launched a backward
     kernel;
 11. training (``phase_train``): ``launch.train.train`` on qwen2-0.5b at
     full width and depth (24 layers, 494 M parameters drawn on the card,
     bf16 with an fp32 AdamW master, SyntheticLM batches of 8 x 1024
     tokens), 8 steps uninterrupted; the same run checkpointing at 4
     under ``build/`` and killed in step 5, then a run resumed from that
     checkpoint to step 8: losses finite and falling, the killed and the
     resumed runs' losses and the resumed run's parameters equal the
     uninterrupted run's bit for bit, each step's launches what 24 layers
     under remat give; step time p50, tokens a second, MFU, peak memory
     and one step under ``torch.profiler``; then (``phase_train_families``)
     6 steps each of granite-moe-1b-a400m (B 8 x S 1024), zamba2-2.7b (B
     4 x S 1024) and whisper-large-v3 (B 4 x S 448, 1500 frames) at full
     width and depth and xlstm-1.3b at full width with 1 of its 6 groups
     (B 4 x S 512): losses finite and the last below the first, each
     step's launches what ``family_train_launches`` gives, one step's
     gradients twice bit-equal, every leaf's gradient finite and nonzero
     (but whisper's key biases, exactly zero), step p50, tokens a second,
     MFU, peak memory, and one step under ``torch.profiler`` with each
     wrapper's counted kernels beside the profiler's;
 12. one JSON line for the kernels (each with its device time and the
     library call's at its phase-4 shape beside the contract's keys, and
     the launches of phase 9f's and phase 11's runs by path; the four
     backward kernels with phase 11's launches), then the result line.

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

from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core import encoders  # noqa: E402
from repro_torch.core.baselines import (all_cloud_policy,  # noqa: E402
                                        evaluate_heuristics, greedy_policy)
from repro_torch.core.d3qn import D3QNAgent, D3QNConfig  # noqa: E402
from repro_torch.core.feature_store import compute_features  # noqa: E402
from repro_torch.core.predictors import (Predictor,  # noqa: E402
                                         PredictorConfig)
from repro_torch.core.qlmio import QLMIO, QLMIOConfig  # noqa: E402
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM  # noqa: E402
from repro_torch.data.taskgen import (CATEGORIES, make_taskset,  # noqa: E402
                                      splits)
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
from repro_torch.launch.train import train as launch_train  # noqa: E402
from repro_torch.models import counting, lm  # noqa: E402
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
from repro_torch.nn.spec import init_params, tree_leaves  # noqa: E402
from repro_torch.sim.cemllm import (make_servers,  # noqa: E402
                                    make_servers_from_spec, run_policy)
from repro_torch.sim.miobench import SERVER_CLASSES, generate  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.optimizer import leaves as opt_leaves  # noqa: E402
from repro_torch.train.optimizer import tree_map as opt_tree_map  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    tree_paths as opt_tree_paths)

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
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "moe_gmm_bwd": "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
           "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"}
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
# the dense families (phase 9f): xlstm-1.3b at full width and depth and
# whisper-large-v3 at full width, each through ServingEngine(max_batch 8)
# on the dense backend with monolithic prefill.  xlstm's prompts obey the
# prompt-length rule (any length up to scan_chunk 256, past it whole
# chunks); whisper's decoder prompts take 1-64 tokens, and its engine the
# decoder's production maximum of 448 positions
# (configs/whisper_large_v3.py)
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PROMPTS = (1, 3, 37, 100, 200, 256, 512, 768)
WHISPER_ARCH = "whisper-large-v3"
WHISPER_PROMPTS = (1, 4, 9, 16, 23, 33, 50, 64)
WHISPER_MAX_SEQ = 448
# scripts/smoke_decode.py's consistency check, here in bf16 on the card:
# the last logits of prefill(S + 1) against prefill(S) then serve_step,
# within 2e-2 of the largest |logit|
CONSISTENCY_S, CONSISTENCY_RTOL = 33, 2e-2
# the continuum (phase 9d): fig10's spec (one cloud llama3.2-3b, two edge
# qwen2-0.5b) and smoke budget (benchmarks/fig10_continuum_replay.py:43-52):
# 32 users of generate(seed=0, n_tasks=200), an arrival every 0.01 virtual s
CONTINUUM_SPEC = [(2, 1), (1, 1), (0, 1)]
CONTINUUM_TASKS = 200
CONTINUUM_USERS = 32
CONTINUUM_ARRIVAL_DT = 0.01
# decode tokens a request has before Cluster.migrate moves it (phase 9d)
MIGRATE_AFTER = 3
# the paper's learning pipeline (phase 9e): features of every MIOBench
# task (LEARN_TASKS None: all 3,377) at the "paper" encoder profile;
# MILP/MGQP at benchmarks/common.py's "paper" budget (50 epochs, batch
# 256, seed 0); QLMIO at examples/quickstart.py's (5 servers, 120
# episodes of 15 users, eps_decay_steps 900, 10 evaluation trials);
# tests/test_core.py's learning run (300 tasks, "tiny" features, oracle
# predictions, 40 episodes of 10 users, eps_decay_steps 250, batch 64)
LEARN_PROFILE = "paper"
LEARN_TASKS = None
LEARN_BATCH = 128
LEARN_EPOCHS = 50
QS_SERVERS, QS_EPISODES, QS_USERS, QS_TRIALS = 5, 120, 15, 10
ORACLE_TASKS, ORACLE_PROFILE = 300, "tiny"
# encoder features, card against CPU on the same weights, of their RMS
# (12 fp32 layers whose products cuBLAS and the CPU's BLAS sum in other
# orders; TF32 off)
ENC_PARITY_TASKS = 8
ENC_PARITY_RTOL = 1e-4
# one Adam step, card against CPU from the same weights and batch: the
# loss, and each gradient, of the network's largest gradient; each
# parameter within 1e-6 + 2 lr min(1, STEP_GRAD_RTOL s / |g|) (Adam
# divides a gradient by its own magnitude: a gradient at rounding level
# moves its value by up to lr either way; tests/test_torch_core_qlmio.py)
STEP_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-5
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
# whisper-large-v3, 20 heads of 64: the encoder over its 1500 frames
# (non-causal; 1500 is not a multiple of the key tile), the decoder's
# cross-attention at prefill (prompts of 1, 33 and 64 tokens against the
# 1500 frames, non-causal) and its causal self-attention at 64 tokens
FLASH_CASES += [(1, 1500, 1500, 20, 20, 64, False, 0),
                (1, 1, 1500, 20, 20, 64, False, 0),
                (1, 33, 1500, 20, 20, 64, False, 0),
                (1, 64, 1500, 20, 20, 64, False, 0),
                (1, 64, 64, 20, 20, 64, True, 0)]
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
FLASH_PLANS = [("whisper-large-v3 encoder (fp32 parity runs)", 1, 1500, 20),
               ("encoder 128x128 batch", 4, 256, 2),
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
# ... and xlstm-1.3b's: d 2048 (every block's pre-norm, the sLSTM's out
# and FFN norms, the final norm) and d_in 4096 (the mLSTM's out norm) at a
# decode tick of 8 slots and a 768-token prompt
RMS_SHAPES += [(8, 2048), (8, 4096), (768, 2048), (768, 4096)]
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
# ... and whisper-large-v3's decode tick at 8 slots, 20 heads of 64: the
# cross-attention over the 1500 frames, every one visible (the query at
# position 1500; the split plan cuts 1500 keys into ragged splits), and
# the self-attention over the decoder's 448 positions, ragged contexts
DECODE_CASES += [(8, 1500, 20, 20, 64, 0, True, dict(all_visible=True)),
                 (8, 448, 20, 20, 64, 0, True)]
# flash decode's split plan at the shapes the serving paths give it (phase
# 2): (label, B, H, Hkv, D), max_seq 1024
# and key count S
FLASH_DECODE_PLANS = [
    ("qwen2-0.5b dense tick and draft", 8, 14, 2, 64, 1024),
    ("qwen2-0.5b, one slot", 1, 14, 2, 64, 1024),
    ("zamba2-2.7b shared attention", 8, 32, 32, 80, 1024),
    ("gemma3-1b local layers", 8, 4, 1, 256, 1024),
    ("whisper-large-v3 cross-attention", 8, 20, 20, 64, 1500),
    ("whisper-large-v3 self-attention", 8, 20, 20, 64, 448)]
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
# the variants it serves).  xlstm and whisper have the dense backend with
# monolithic prefill only (whisper with each request's frames).  The dense
# configs serve every variant.  The
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
           ("bf16", "bf16 spec", "int8", "dense chunked")),
          ("xlstm-1.3b", {}, 3, ("dense monolithic",)),
          ("whisper-large-v3", {}, 3, ("dense monolithic",))]
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


# torch.profiler sessions a reading may take, and the pause after one that
# recorded nothing: on the card's host about one session in 500 records
# none of its window's kernels (or only some), in runs of up to three
# back-to-back sessions, some 30 ms (scripts/profiler_gaps.py); a pause
# of PROFILE_GAP_S outlasts such a run
PROFILE_TRIES = 8
PROFILE_GAP_S = 0.5


def _kernels(prof) -> list:
    """A finished profiler session's kernels with device time."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]


def profiled(run, label: str):
    """``run(profiler)`` with a new ``torch.profiler`` (device activity
    only) that ``run`` enters around what it measures, run again while its
    session records no device time, up to ``PROFILE_TRIES`` times: the last
    run's result and its session's kernels.  Fails when no session
    recorded any."""
    for attempt in range(1, PROFILE_TRIES + 1):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        out = run(prof)
        kernels = _kernels(prof)
        if kernels:
            return out, kernels
        print(f"[profiler] {label}: session {attempt} of {PROFILE_TRIES} "
              "recorded no device time")
        time.sleep(PROFILE_GAP_S)
    raise RuntimeError(f"the profiler saw no device time in {PROFILE_TRIES} "
                       f"sessions ({label})")


def queued_ms(fn, calls: int) -> float:
    """Mean milliseconds per call of ``fn(i)`` by CUDA events, the calls
    issued while a sleep kernel of about 50 ms holds the stream, so that
    the events time the calls' kernels back to back and not the host that
    issues them (checked: the host issued them all before the sleep
    ended)."""
    fn(0)
    torch.cuda.synchronize()
    slept, start, stop = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    slept.record()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    start.record()
    for i in range(calls):
        fn(i)
    stop.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = slept.elapsed_time(start)
    check(issue_ms < sleep_ms, f"issuing {calls} calls took {issue_ms:.1f} "
          f"ms, longer than the {sleep_ms:.1f} ms sleep kernel that hides it")
    return start.elapsed_time(stop) / calls


def device_ms(fn, calls: int = 20, by_kernel: "dict | None" = None
              ) -> float:
    """Mean device time per call of ``fn(i)``: the kernels it launches as
    ``torch.profiler`` records them, without the host's time between
    launches (which sets ``cuda_ms`` of a call whose kernels are short).
    The window is profiled until three sessions have recorded device time
    (at most ``PROFILE_TRIES`` sessions) and the fullest reading kept: on
    the card's host a session now and then records none or only some of
    the window's kernels (an SDPA call read 0.0009 ms of its usual 0.022
    once, and whole windows came back empty), and a lost kernel can only
    lower a reading.  Where no session recorded any, the window is timed
    by ``queued_ms`` instead, and a line says so.  ``by_kernel``, if
    given, receives the reading's kernels (name -> ms a call; nothing
    from ``queued_ms``)."""
    fn(0)
    torch.cuda.synchronize()
    best_us, best, seen = 0.0, [], 0
    for _ in range(PROFILE_TRIES):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        events = _kernels(prof)
        us = sum(dev_us(e) for e in events)
        if us > best_us:
            best_us, best = us, events
        seen += us > 0
        if seen == 3:
            break
        if us == 0:
            time.sleep(PROFILE_GAP_S)
    if best_us == 0:
        ms = queued_ms(fn, calls)
        print(f"[profiler] no device time in {PROFILE_TRIES} sessions: "
              f"{ms:.4f} ms a call by CUDA events behind a sleep kernel "
              "instead")
        return ms
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
               free=None, holes=0, last_only=None, all_visible=False):
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
    key is its last).  ``all_visible``: every slot holds all S entries
    and queries at pos = S (whisper's cross-attention: every frame
    visible).  Returns (q, k, v, cpos, pos, rows): ``rows`` the slots
    that see a key."""
    dev = torch.device("cuda")
    lead = (layers,) if layers else ()
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    k = torch.randn(lead + (B, S, Hkv, D), device=dev)
    v = torch.randn(lead + (B, S, Hkv, D), device=dev)
    cpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if all_visible:
        pos = np.full(B, S, np.int32)
    elif not engine:
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


def hmma_count(path, op: str = "HMMA") -> "int | None":
    """HMMA (``mma.sync``) or, with op "HGMMA", ``wgmma`` tensor-core
    instructions in a built library's SASS, or None where ``cuobjdump`` is
    not installed."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return sass.count(op)


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
                                    (8, 3072), (8, 2560), (768, 5120),
                                    (8, 2048), (8, 4096), (768, 4096))
                    for dt in (torch.bfloat16, torch.float32)))
    spills = ptxas_spills(infos["rmsnorm"]["ptxas"])
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills if n]
    check(not spilled, "rmsnorm.cu: register spills: " + ", ".join(spilled))
    print("[build]   rmsnorm: " + (
        f"{len(spills)} instantiations, none spills" if spills
        else "already built, ptxas not rerun"))
    print("[build]   rmsnorm backward plan (CTAs, warps a CTA; one warp a "
          "row): " + "; ".join(f"[{rows}, {d}] {rms_kernel.bwd_plan(rows, d)}"
                              for rows, d in ((8192, 896), (8192, 1152),
                                              (32768, 256), (8192, 3072),
                                              (1, 896))))
    spills = ptxas_spills(infos["flash_attention_bwd"]["ptxas"])
    spilled = [f"{name} ({n} bytes)" for name, D, n in spills if n]
    check(not spilled, "flash_attention_bwd.cu: register spills: "
          + ", ".join(spilled))
    hmma = hmma_count(infos["flash_attention_bwd"]["path"])
    check(hmma is None or hmma > 0, "flash_attention_bwd.cu: no HMMA "
          "(tensor-core) instruction in its SASS")
    for dt, kind in ((torch.bfloat16, "bf16 tensor-core"),
                     (torch.float32, "fp32 CUDA-core")):
        print(f"[build]   flash attention backward ({kind} kernels): "
              "dynamic shared memory a CTA " + "; ".join(
                  f"D {D}: key pass {kv}, query pass {qp} bytes"
                  for D in flash_attention.BWD_HEAD_DIMS
                  for kv, qp in [flash_attention.bwd_smem_bytes(D, dt)]))
    print("[build]   flash attention backward: "
          + (f"{len(spills)} kernels, none spills" if spills
             else "already built, ptxas not rerun")
          + "; bf16 key-pass plan (splits, CTAs of "
          f"{flash_attention.BWD_KEYS} keys): " + "; ".join(
              f"{label} {splits}, "
              f"{-(-S // flash_attention.BWD_KEYS) * Hkv * B * splits}"
              for label, B, S, _, H, Hkv, D, _, _ in FLASH_BWD_ROWS
              for splits in [flash_attention.bwd_plan(B, S, S, H, Hkv,
                                                      D)]))
    print("[build]   grouped matmul: " + "; ".join(
        f"{str(dt)[6:]} C {C}: {moe_gmm.variant(dt, C)}"
        for dt in (torch.bfloat16, torch.float32) for C in (8, 16, 24, 320)))
    print("[build]   flash decode: " + "; ".join(
        f"{str(q)[6:]} q, {str(c)[6:]} cache: {flash_decode.variant(q, c)}"
        for q, c in itertools.product((torch.bfloat16, torch.float32),
                                      flash_decode.CACHE_DTYPES)))
    for label, B, H, Hkv, D, S in FLASH_DECODE_PLANS:
        p = flash_decode.plan(B, H // Hkv, Hkv, S, D)
        smem = [flash_decode.smem_bytes(H // Hkv, D, p.split_keys, p.splits,
                                        dt)
                for dt in (torch.bfloat16, torch.int8)]
        print(f"[build]   flash decode, {label} (B {B}, heads {H}/{Hkv}, D "
              f"{D}, S {S}), bf16 q: {p.split_keys} keys a split "
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
    for name in ("moe_gmm_bwd", "ssd_scan_bwd"):
        spills = ptxas_spills(infos[name]["ptxas"])
        spilled = [f"{k} ({n} bytes)" for k, D, n in spills if n]
        check(not spilled, f"{name}.cu: register spills: "
              + ", ".join(spilled))
        print(f"[build]   {name}: " + (
            f"{len(spills)} kernels, none spills" if spills
            else "already built, ptxas not rerun"))
    path = infos["moe_gmm_bwd"]["path"]
    hgmma, hmma = hmma_count(path, "HGMMA"), hmma_count(path)
    check(hgmma is None or hgmma > 0, "moe_gmm_bwd.cu: no HGMMA (wgmma) "
          "instruction in its SASS")
    check(hmma is None or hmma > 0, "moe_gmm_bwd.cu: no HMMA (mma.sync) "
          "instruction in its SASS (the unaligned rows' tiles)")
    print(f"[build]   grouped matmul backward: {hgmma} HGMMA (wgmma) and "
          f"{hmma} HMMA (mma.sync) instructions in its SASS; " + "; ".join(
              f"{str(dt)[6:]} K {K}, N {N}{'' if al else ', unaligned base'}"
              f": {moe_gmm.bwd_variant(dt, K, N, al)}"
              for dt, K, N, al in ((torch.bfloat16, 1024, 512, True),
                                   (torch.bfloat16, 70, 90, True),
                                   (torch.bfloat16, 1024, 512, False),
                                   (torch.float32, 1024, 512, True))))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("[build]   grouped matmul backward, persistent schedule "
          f"({moe_gmm.BWD_TILE[0]} x {moe_gmm.BWD_TILE[1]} tiles, steps of "
          f"{moe_gmm.BWD_STEP}; dw tiles, then dx tiles): " + "; ".join(
              f"{label} {len(tiles)} tiles ({n_dw} dw of {tiles[0].steps} "
              f"steps), {moe_gmm.bwd_grid(E, C, K, N, sms)} CTAs"
              for label, E, C, K, N in GMM_BWD_CASES[:3]
              for tiles in [moe_gmm.bwd_tiles(E, C, K, N)]
              for n_dw in [sum(t.out == "dw" for t in tiles)]))
    hmma = hmma_count(infos["ssd_scan_bwd"]["path"])
    check(hmma is None or hmma > 0, "ssd_scan_bwd.cu: no HMMA (tensor-core) "
          "instruction in its SASS (the bf16 passes 1 and 3)")
    print(f"[build]   ssd scan backward: {hmma} HMMA instructions in its "
          "SASS; " + "; ".join(
              f"{str(dt)[6:]} x, p {p}, n {n}: "
              f"{scan_kernel.bwd_variant(dt, p, n)}"
              for dt, p, n in ((torch.bfloat16, 64, 64),
                               (torch.bfloat16, 80, 64),
                               (torch.float32, 64, 64))))
    print("[build]   ssd scan backward (blocks of "
          f"{scan_kernel.bwd_block(256)} tokens at chunk 256) at zamba2's p "
          "64, n 64: dynamic shared memory a CTA " + "; ".join(
              f"{str(dt)[6:]} " + ", ".join(
                  f"{k} {v}" for k, v in
                  scan_kernel.bwd_smem_bytes(64, 64, dt).items())
              for dt in (torch.bfloat16, torch.float32)) + " bytes; scratch "
          "at B 4 x S 1024, 80 heads: "
          f"{scan_kernel.bwd_scratch_bytes(4, 1024, 80, 64, 64, 256)} "
          "bytes")
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
    heads of 80, causal bf16), whisper-large-v3's encoder over its 1500
    frames (non-causal), its cross-attention at a 64-token prefill (Sq 64
    against Sk 1500, non-causal) and its decoder's causal self-attention
    at 64 tokens (B 1, 20 heads of 64, bf16); each row names the
    instantiation that ran;
    the yardstick is ``F.scaled_dot_product_attention`` on [B, H, S, D]
    copies (``enable_gqa``, ``is_causal``).  RMSNorm: a decode tick
    [8, 896] (the kernels-line entry) and a prefill chunk [64, 896] of
    bf16 activations with bf16 scales, the encoder's [1024, 896] in
    fp32, and xlstm-1.3b's widths in bf16 at a decode tick of 8 slots (d
    2048 and d_in 4096) and a 768-token prompt (d_in 4096); the yardstick
    is ``F.rms_norm`` with the scale in x's type.
    The flash bound counts the visible (query, key) pairs' q.k and p.v
    multiply-adds (2 flops each) at the peak of the inputs' type: bf16
    989 TFLOP/s (the tensor cores, on which the bf16 instantiation
    multiplies), fp32 67 TFLOP/s (outside the tensor cores: the fp32
    instantiation multiplies on the CUDA cores, never in TF32)."""
    dev = torch.device("cuda")
    out = {}
    # (label, B, Sq, Sk, H, Hkv, D, dtype, causal)
    shapes = [("encoder 128x128", 4, 256, 256, 2, 2, 448, torch.float32,
               False),
              ("encoder 32x32", 4, 16, 16, 2, 2, 448, torch.float32, False)]
    shapes += [(f"draft prefill S {S}", 1, S, S, 14, 2, 64, torch.bfloat16,
                True) for S in (64, 128, 256, 512, 1024)]
    shapes += [("zamba2 shared attention", 1, 768, 768, 32, 32, 80,
                torch.bfloat16, True),
               ("whisper encoder", 1, 1500, 1500, 20, 20, 64,
                torch.bfloat16, False),
               ("whisper cross-attention", 1, 64, 1500, 20, 20, 64,
                torch.bfloat16, False),
               ("whisper decoder", 1, 64, 64, 20, 20, 64, torch.bfloat16,
                True)]
    for label, B, Sq, S, H, Hkv, D, dt, causal in shapes:
        q = torch.randn(B, Sq, H, D, device=dev, dtype=dt)
        k = torch.randn(B, S, Hkv, D, device=dev, dtype=dt)
        v = torch.randn(B, S, Hkv, D, device=dev, dtype=dt)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * (S * (S + 1) // 2 if causal else Sq * S)
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * k.numel() * k.element_size()

        def library(i=0, qt=qt, kt=kt, vt=vt, causal=causal):
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)

        row = _time_call("flash_attention",
                         f"{label}: B={B} "
                         + (f"S={S}" if Sq == S else f"Sq={Sq} Sk={S}")
                         + f" H={H}/{Hkv} D={D} "
                         f"{'causal' if causal else 'non-causal'}; "
                         f"{flash_attention.variant(D, dt)}",
                         (q, k, v), dict(causal=causal), nbytes,
                         4 * pairs * H * D, dt, library, smi)
        out.setdefault("flash_attention", row)
    for label, shape, dt in (("decode tick", (8, 896), torch.bfloat16),
                             ("prefill chunk", (64, 896), torch.bfloat16),
                             ("encoder", (1024, 896), torch.float32),
                             ("xlstm tick d", (8, 2048), torch.bfloat16),
                             ("xlstm tick d_in", (8, 4096), torch.bfloat16),
                             ("xlstm 768-token prefill d_in", (768, 4096),
                              torch.bfloat16)):
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
            ("granite training gate/up (B 8 x S 1024)", 32, 2560, 1024,
             512, 2),
            ("granite training down", 32, 2560, 512, 1024, 2),
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
    ("dense decode", 8, 14, 2, 64, 1024, DENSE_CTX, (), 24),
    ("one slot", 1, 14, 2, 64, 1024, np.asarray([1000]), (), 24),
    ("2 free slots", 8, 14, 2, 64, 1024, DENSE_CTX, (6, 7), 24),
    ("zamba2 shared attention", 8, 32, 32, 80, 1024, DENSE_CTX, (), 9),
    # whisper-large-v3's tick: 32 layers of cross-attention over the 1500
    # frames (each visible) and of self-attention over a 448-position
    # cache holding 40-100 tokens (prompts of 1-64 plus up to 32 new)
    ("whisper cross-attention", 8, 20, 20, 64, 1500, np.full(8, 1500), (),
     32),
    ("whisper self-attention", 8, 20, 20, 64, 448,
     np.asarray([40, 48, 55, 63, 70, 80, 90, 100]), (), 32)]


def _time_flash_decode(smi: str) -> dict:
    """Flash decode at the dense path's shapes (FLASH_DECODE_TIMING): an
    S-entry cache per layer (taken in turn) holding the given
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
    out = {}
    for label, B, H, Hkv, D, S, ctx, free, L in FLASH_DECODE_TIMING:
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


def _engine(model, params, kv_dtype, telemetry=None, extra=None, **kw):
    """An engine for the main path whose first cuBLAS calls and caches are
    already warm (one short request, with ``extra`` where the model needs
    it, then metrics and prefix cache reset); ``kw`` reaches the engine
    (the speculation knobs, another ``max_seq``)."""
    vocab = model.cfg.vocab
    kw = {**dict(max_batch=8, page_size=16, max_seq=1024), **kw}
    eng = ServingEngine(model, params, kv_dtype=kv_dtype,
                        device=_device_of(params),
                        telemetry=telemetry, **kw)
    eng.submit(Request(-1, np.arange(40) % vocab, max_new_tokens=4,
                       extra=extra))
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
    tels = []

    def run(prof):
        tels.append(Telemetry(trace=True))
        return window(tels[-1], prof)

    # device activity only: the kernels' device time is all that is read
    (pwall, calls), kernels = profiled(run, f"{label} window")
    tel = tels[-1]
    spans: dict = {}
    for ev in tel.tracer.events:
        if ev.get("ph") == "X" and ev["cat"] in ("engine", "prefill"):
            n, t = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, t + ev["dur"] / 1e6)
    check(spans.get("decode_tick", (0,))[0] > 0,
          f"the profiled window ran no decode tick: {spans}")
    busy = sum(dev_us(e) for e in kernels) / 1e6
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
    uids = itertools.count(-4, -1)

    def run(prof):
        for w in WRAPPERS.values():
            w.launches = 0
        with prof:
            t0 = time.perf_counter()
            prefill(next(uids))
            return time.perf_counter() - t0

    wall, kernels = profiled(run, "hybrid prefill")
    calls = scan_kernel.ssd_scan.launches
    check(calls == cfg.n_layers, f"the profiled prefill made {calls} "
          f"ssd_scan calls, want {cfg.n_layers}")
    busy = sum(dev_us(e) for e in kernels) / 1e3
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


def family_model(arch: str, tag: str):
    """``arch`` at full width and depth, random bf16 weights drawn on the
    card from seed 0; prints the model's shape and parameter count."""
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    if cfg.block_kind == "xlstm":
        G, P = lm.xlstm_groups(cfg)
        d_in = int(cfg.proj_factor * cfg.d_model)
        shape = (f"{cfg.n_layers} blocks in {G} groups of {P} mLSTM and 1 "
                 f"sLSTM, d {cfg.d_model}, d_in {d_in}, {cfg.n_heads} heads "
                 f"of {d_in // cfg.n_heads} (sLSTM "
                 f"{cfg.d_model // cfg.n_heads}), conv width "
                 f"{cfg.conv_width}, scan_chunk {cfg.scan_chunk}")
    else:
        shape = (f"{cfg.encoder_layers} encoder and {cfg.n_layers} decoder "
                 f"layers, d {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd},"
                 f" d_ff {cfg.d_ff}, {cfg.encoder_seq} encoder frames")
    print(f"[{tag}] {arch} at full width and depth: {shape}; vocab "
          f"{cfg.vocab}; {n:,} parameters, {nbytes / 1e9:.2f} GB in bf16, "
          f"drawn on the card from seed 0 in {secs:.2f} s")
    return model, params


def _device_of(params) -> torch.device:
    return params["embed"]["table"].device


def grown(cache: dict) -> dict:
    """One more, empty entry in the sequence dim of the positional leaves
    (k/v zeros, pos_map -1), for a decode step's token to land in."""
    out = dict(cache)
    for name in ("k", "v"):
        if name in out:
            c = out[name]
            out[name] = torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
    if "pos_map" in out:
        pm = out["pos_map"]
        out["pos_map"] = torch.cat([pm, torch.full_like(pm[:, :1], -1)], 1)
    return out


def consistency(model, params, extra: dict, tag: str, smi: str,
                held=("bfloat16", "float32")):
    """scripts/smoke_decode.py's check on the card, with the activations in
    bf16 and in fp32 (the same bf16 weights, cast at each use): two
    prompts of CONSISTENCY_S + 1 tokens; the last logits of ``prefill``
    over all of them against ``prefill`` over the first CONSISTENCY_S,
    then one ``serve_step`` at position CONSISTENCY_S, within
    CONSISTENCY_RTOL of the largest |logit| for the activation types in
    ``held``, printed for the others."""
    S = CONSISTENCY_S
    dev = _device_of(params)
    rng = np.random.default_rng(21)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, S + 1)))
    toks = toks.to(dev)
    for act in ("bfloat16", "float32"):
        m = build_model(dataclasses.replace(model.cfg, act_dtype=act))
        full, _ = m.prefill(params, {"tokens": toks, **extra})
        _, cache = m.prefill(params, {"tokens": toks[:, :S], **extra})
        step, _ = m.serve_step(params, grown(cache), {
            "tokens": toks[:, S],
            "pos": torch.full((2,), S, dtype=torch.int32, device=dev)})
        err = float((full - step).abs().max() / full.abs().max())
        check(bool(torch.isfinite(step).all())
              and (err < CONSISTENCY_RTOL or act not in held),
              f"{model.cfg.name}: prefill({S + 1}) and prefill({S}) + "
              f"serve_step disagree by {err:.3e} of the largest |logit| "
              f"({act} activations)")
        print(f"[{tag}] consistency, {act} activations, bf16 weights: "
              f"prefill({S + 1})'s last logits against prefill({S}) + "
              f"serve_step: {err:.3e} of the largest |logit| "
              + (f"(held to {CONSISTENCY_RTOL})" if act in held
                 else "(printed)") + f" ({smi})")


def profile_call(tag: str, label: str, fn, smi: str) -> float:
    """``fn`` once plainly to warm its shapes, once more timed by the host
    (wall, ending on a synchronize), and once under ``torch.profiler``
    (device activity only): the device busy time, the idle share of the
    plain call's wall, the top kernels and the port's kernels' device
    time and launches.  Returns the busy milliseconds."""
    fn()
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    calls = {n: w.launches for n, w in WRAPPERS.items() if w.launches}

    def run(prof):
        with prof:
            fn()
            torch.cuda.synchronize()

    _, kernels = profiled(run, f"{tag} {label}")
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(f"[{tag}] profile of {label}: wall {wall:.2f} ms, device busy "
          f"{busy:.3f} ms, idle {1 - busy / wall:.1%}; wrapper calls "
          f"{calls} ({smi})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")
    for what, match in (
            ("flash attention", lambda k: "flash_fp32" in k
             or "flash_attention_" in k),
            ("flash decode", lambda k: "DenseKeys" in k
             or "flash_decode_kernel" in k),
            ("RMSNorm", lambda k: "rmsnorm_kernel" in k)):
        sel = [e for e in kernels if match(e.key)]
        if sel:
            ms = sum(dev_us(e) for e in sel) / 1e3
            print(f"[{tag}]   {what}: {ms:.3f} ms of device time "
                  f"({ms / busy:.1%} of busy), "
                  f"{sum(e.count for e in sel)} kernel launches")
    return busy


def xlstm_norms(cfg) -> int:
    """RMSNorm launches of one xlstm prefill or decode step: the pre-norm
    and out norm of every mLSTM block, the pre-norm, out norm and FFN norm
    of every sLSTM block, and the final norm."""
    G, P = lm.xlstm_groups(cfg)
    return 2 * G * P + 3 * G + 1


def phase_xlstm(smi: str) -> dict:
    """xlstm-1.3b at full width and depth serves 8 requests
    (XLSTM_PROMPTS, 32 new tokens each) through ``ServingEngine(max_batch
    8, max_seq 1024)``, which takes the dense backend and exact-shape
    monolithic prefill for it; RMSNorm launches must equal
    ``xlstm_norms`` x (prefills + decode steps), every other kernel none.
    On a one-slot engine a 300-token prompt is refused at submission (the
    prompt-length ValueError) and a 2-token prompt at admission (its two
    conv rows do not broadcast into the window of three).  Then the
    consistency check (held with fp32 activations, printed with bf16
    ones), the mC state's size, and one 768-token prefill and one decode
    tick of the 8 slots under ``torch.profiler``.  Returns the
    run's launch counts."""
    tag = "xlstm"
    model, params = family_model(XLSTM_ARCH, tag)
    cfg = model.cfg
    V = cfg.vocab
    nps = xlstm_norms(cfg)
    dev = _device_of(params)
    one = ServingEngine(model, params, max_batch=1, max_seq=1024,
                        device=dev)
    refused = ""
    try:
        one.submit(Request(-2, np.arange(300) % V, max_new_tokens=4))
    except ValueError as e:
        refused = str(e)
    check("multiple" in refused and not one.busy(),
          f"a 300-token prompt was not refused: {refused!r}")
    print(f"[{tag}] a 300-token prompt is refused at submission: "
          f"ValueError: {refused}")
    one.submit(Request(-3, np.arange(2), max_new_tokens=4))
    refused = ""
    try:
        one.run_until_drained()
    except ValueError as e:
        refused = str(e)
    check("broadcast" in refused, f"a 2-token prompt was not refused at "
          f"admission: {refused!r}")
    print(f"[{tag}] a 2-token prompt is refused at admission: ValueError: "
          f"{refused}")
    del one
    eng = _engine(model, params, "bf16")
    rng = np.random.default_rng(13)
    reqs = [Request(i, rng.integers(0, V, n), max_new_tokens=32)
            for i, n in enumerate(XLSTM_PROMPTS)]
    wall, counts, st = _drive(eng, reqs)
    prefills, steps = st["prefills"], st["decode_steps"]
    want = {n: 0 for n in WRAPPERS}
    want["rmsnorm"] = nps * (prefills + steps)
    check(counts == want, f"{XLSTM_ARCH} launched {counts}, want {want} "
          f"({prefills} prefills, {steps} decode steps)")
    check(not st["paged"] and not st["chunked"] and not st["bucketed"]
          and prefills == len(reqs) and st["prefill_chunks"] == 0,
          f"{XLSTM_ARCH}: paged {st['paged']}, chunked {st['chunked']}, "
          f"bucketed {st['bucketed']}, {prefills} prefills")
    sizes = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]} "
                      f"{v.numel() * v.element_size() / 1e6:.1f} MB"
                      for k, v in eng.cache.items())
    print(f"[{tag}] dense cache at {eng.max_batch} slots: {sizes}")
    print(f"[{tag}] dense backend, monolithic exact-shape prefill: "
          f"{len(reqs)} requests, prompts {sum(XLSTM_PROMPTS)} tokens "
          f"(lengths {list(XLSTM_PROMPTS)}) in {prefills} prefills, "
          f"{st['decode_tokens']} decode tokens in {steps} decode steps, "
          f"{wall:.3f} s wall; {_latency_line(st, wall)}; launches: rmsnorm "
          f"{want['rmsnorm']} = {nps} x ({prefills} + {steps}) ({smi})")
    # in bf16 the two paths round differently (a 34-row and a 1-row GEMM,
    # the conv's bf16 sums against its one-row einsum) and 48 recurrent
    # blocks carry it: the JAX package's own xlstm in bf16 exceeds 2e-2
    # already at reduced width (tests/test_torch_zoo.py::
    # test_xlstm_bf16_gap_is_the_references), so the fp32 run is held
    consistency(model, params, {}, tag, smi, held=("float32",))
    prompt = torch.from_numpy(rng.integers(0, V, (1, max(XLSTM_PROMPTS))))
    prompt = prompt.to(dev)
    profile_call(tag, f"one monolithic prefill of {prompt.shape[1]} tokens",
                 lambda: model.prefill(params, {"tokens": prompt}), smi)
    tick = {"tokens": torch.zeros(eng.max_batch, dtype=torch.long,
                                  device=dev),
            "pos": torch.full((eng.max_batch,), 100, dtype=torch.int32,
                              device=dev)}
    busy = profile_call(tag, f"one decode tick of {eng.max_batch} slots",
                        lambda: model.serve_step(params, eng.cache, tick),
                        smi)
    mC = eng.cache["mC"]
    slot = mC[:, :, 0].numel() * mC.element_size()
    total = mC.numel() * mC.element_size()
    floor_ms = 2 * total / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] the mC state: {slot / 1e6:.1f} MB a slot ({mC.shape[0]}"
          f" x {mC.shape[1]} mLSTM blocks x {tuple(mC.shape[3:])} fp32), "
          f"{total / 1e9:.2f} GB at {eng.max_batch} slots; read and written "
          f"once a tick at the HBM rate: {floor_ms:.2f} ms, against the "
          f"tick's {busy:.2f} ms of device time ({smi})")
    del eng, model, params
    return counts


def whisper_frames(cfg, n: int, seed: int) -> list:
    """``n`` requests' encoder frames [1, Se, d] fp32 (the stub
    frontend's input), drawn from numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, cfg.encoder_seq, cfg.d_model),
                                dtype=np.float32) for _ in range(n)]


def phase_whisper(smi: str) -> dict:
    """whisper-large-v3 at full width and depth serves 8 requests, each
    with its own encoder frames and a decoder prompt of WHISPER_PROMPTS
    tokens (32 new tokens each), through ``ServingEngine(max_batch 8,
    max_seq WHISPER_MAX_SEQ)``, which takes the dense backend and bucketed
    monolithic prefill for it; flash-attention launches must equal
    (encoder layers + 2 x decoder layers) x prefills, flash-decode
    launches 2 x decoder layers x decode steps, every other kernel none
    (its LayerNorms are plain in both packages).  Then the consistency
    check (held with bf16 and fp32 activations) and one 64-token prefill
    and one decode tick of the 8 slots under ``torch.profiler``.  Returns
    the run's launch counts."""
    tag = "whisper"
    model, params = family_model(WHISPER_ARCH, tag)
    cfg = model.cfg
    L, Le = cfg.n_layers, cfg.encoder_layers
    dev = _device_of(params)
    frames = whisper_frames(cfg, len(WHISPER_PROMPTS) + 1, seed=14)
    eng = _engine(model, params, "bf16", max_seq=WHISPER_MAX_SEQ,
                  extra={"encoder_frames": frames[-1]})
    rng = np.random.default_rng(15)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n), max_new_tokens=32,
                    extra={"encoder_frames": frames[i]})
            for i, n in enumerate(WHISPER_PROMPTS)]
    wall, counts, st = _drive(eng, reqs)
    prefills, steps = st["prefills"], st["decode_steps"]
    want = {n: 0 for n in WRAPPERS}
    want["flash_attention"] = (Le + 2 * L) * prefills
    want["flash_decode"] = 2 * L * steps
    check(counts == want, f"{WHISPER_ARCH} launched {counts}, want {want} "
          f"({prefills} prefills, {steps} decode steps)")
    check(not st["paged"] and not st["chunked"] and st["bucketed"]
          and prefills == len(reqs) and st["prefill_chunks"] == 0,
          f"{WHISPER_ARCH}: paged {st['paged']}, chunked {st['chunked']}, "
          f"bucketed {st['bucketed']}, {prefills} prefills")
    sizes = ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype)[6:]} "
                      f"{v.numel() * v.element_size() / 1e6:.1f} MB"
                      for k, v in eng.cache.items())
    print(f"[{tag}] dense cache at {eng.max_batch} slots, max_seq "
          f"{eng.max_seq}: {sizes}")
    print(f"[{tag}] dense backend, bucketed monolithic prefill: "
          f"{len(reqs)} requests of {cfg.encoder_seq} frames each, decoder "
          f"prompts {sum(WHISPER_PROMPTS)} tokens (lengths "
          f"{list(WHISPER_PROMPTS)}, {st['prefill_tokens_padded']} padded) "
          f"in {prefills} prefills, {st['decode_tokens']} decode tokens in "
          f"{steps} decode steps, {wall:.3f} s wall; "
          f"{_latency_line(st, wall)}; launches: flash_attention "
          f"{want['flash_attention']} = ({Le} + 2 x {L}) x {prefills}, "
          f"flash_decode {want['flash_decode']} = 2 x {L} x {steps} ({smi})")
    two = np.concatenate(frames[:2])
    consistency(model, params, {"encoder_frames": torch.from_numpy(two)
                                .to(dev)}, tag, smi)
    Sp = max(WHISPER_PROMPTS)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, Sp)))
             .to(dev),
             "length": torch.tensor([Sp], dtype=torch.int32, device=dev),
             "encoder_frames": torch.from_numpy(frames[0]).to(dev)}
    profile_call(tag, f"one monolithic prefill of {cfg.encoder_seq} frames "
                 f"and {Sp} decoder tokens",
                 lambda: model.prefill(params, batch), smi)
    tick = {"tokens": torch.zeros(eng.max_batch, dtype=torch.long,
                                  device=dev),
            "pos": torch.full((eng.max_batch,), 100, dtype=torch.int32,
                              device=dev)}
    profile_call(tag, f"one decode tick of {eng.max_batch} slots",
                 lambda: model.serve_step(params, eng.cache, tick), smi)
    del eng, model, params
    return counts


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
        # media requests need embedding spans (the decoder-only attention
        # family); whisper's requests carry their own encoder frames
        feats = (reduced_mm_features(cfg.d_model)
                 if model.supports_embed_spans else None)
        frames = (whisper_frames(cfg, len(prompts), seed=3)
                  if cfg.cross_attention else [None] * len(prompts))

        def serve(dev, params, spec, **kw):
            if spec:
                kw.update(draft_config=cfg, draft_params=params,
                          spec_k=SPEC_K)
            eng = ServingEngine(model, params, max_batch=max_batch,
                                max_seq=128,
                                device=dev, **{**dict(
                                    page_size=8, prefill_chunk=16), **kw})
            reqs = [Request(i, p, max_new_tokens=8,
                            extra=None if f is None
                            else {"encoder_frames": f})
                    for i, (p, f) in enumerate(zip(prompts, frames))]
            if feats is not None:
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
            kinds = (f"{len(MM_ORDER)} multimodal" if feats is not None
                     else f"no multimodal ({cfg.name} takes no embedding "
                     "spans)")
            print(f"[parity] reduced {arch} fp32, {label} engine: CPU "
                  f"(plain) and CUDA (kernels) engines give identical tokens "
                  f"for {len(prompts)} "
                  f"{'audio (own frames)' if cfg.cross_attention else 'text'}"
                  f" and {kinds} requests")
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


def encoder_flops(p) -> "tuple[float, float]":
    """Operations (2 per multiply-add) of one task through the frozen ViT
    and BERT of profile ``p``: the patch projection, each layer's q, k, v,
    o and MLP products, QK^T and PV over every key (BERT's padded keys
    included, as ``encoders.bert_encode`` computes them)."""
    def stack(S, d, mlp, n_layers):
        return n_layers * (2 * S * (4 * d * d + 2 * d * mlp)
                           + 2 * 2 * S * S * d)

    n_patch = (p.img_size // p.patch) ** 2
    vit = (2 * n_patch * p.patch * p.patch * 3 * p.vit_dim
           + stack(n_patch + 1, p.vit_dim, p.vit_mlp, p.vit_layers))
    return vit, stack(p.text_len, p.bert_dim, p.bert_mlp, p.bert_layers)


def flat_records(bench, f_text, f_img, ids) -> dict:
    """The (task, server class) records of ``ids``
    (benchmarks/common.py:41, a numpy copy)."""
    C = len(SERVER_CLASSES)
    t = np.repeat(ids, C)
    c = np.tile(np.arange(C), len(ids))
    return {"f_text": f_text[t], "f_img": f_img[t],
            "model_id": bench.model_id[c], "device_id": bench.device_id[c],
            "label": (bench.score[t, c] == 1).astype(np.int64),
            "latency_s": bench.latency_s[t, c].astype(np.float32)}


@torch.no_grad()
def copy_tree_(dst, src):
    """Copy the tensor tree ``src`` into ``dst`` in place, key by key."""
    for k, v in src.items():
        if isinstance(v, dict):
            copy_tree_(dst[k], v)
        else:
            dst[k].copy_(v)


def learn_features(bench, smi: str):
    """Step 1 of phase 9e: the frozen encoders drawn on the card and the
    features of every task; the encoders' device time at one batch."""
    p = encoders.PROFILES[LEARN_PROFILE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vit, bert, _ = encoders.frozen_encoders(LEARN_PROFILE, seed=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(vit) + tree_leaves(bert))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f_img, f_text = compute_features(bench.tasks, LEARN_PROFILE,
                                     batch=LEARN_BATCH, cache_dir=None)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    N = bench.tasks.n
    for name, f in (("f_img", f_img), ("f_text", f_text)):
        check(f.shape == (N, p.vit_dim) and f.dtype == np.float32,
              f"{name} is {f.shape} {f.dtype}, not [{N}, {p.vit_dim}]")
        check(bool(np.isfinite(f).all()), f"{name} is not finite")
    # the encoders' device time at one batch, the host's media excluded
    idx = np.arange(min(LEARN_BATCH, N))
    imgs = torch.from_numpy(bench.tasks.images(idx, p.img_size)).cuda()
    toks, masks = (torch.from_numpy(a).cuda() for a in
                   bench.tasks.texts(idx, p.text_len, p.bert_vocab))
    vit_ms = cuda_ms(lambda i=0: encoders.vit_encode(vit, imgs, p), 3, 1)
    bert_ms = cuda_ms(lambda i=0: encoders.bert_encode(bert, toks, masks, p),
                      3, 1)
    ops_v, ops_b = encoder_flops(p)
    B = len(idx)
    bound_ms = B * (ops_v + ops_b) / PEAK_OPS_PER_S[torch.float32] * 1e3
    print(f"[learning] frozen encoders (profile {LEARN_PROFILE}: ViT at "
          f"{p.img_size} px, patch {p.patch}, {p.vit_layers} layers of "
          f"{p.vit_dim}; DistilBERT at L {p.text_len}, {p.bert_layers} "
          f"layers of {p.bert_dim}, vocab "
          f"{p.bert_vocab}; {n / 1e6:.1f} M fp32 parameters) drawn on the "
          f"card in {draw_s:.2f} s; features of {N} tasks "
          f"(batch {LEARN_BATCH}) in {secs:.2f} s, {N / secs:.1f} tasks/s, "
          f"peak device memory {peak / 2 ** 30:.2f} GiB ({smi})")
    print(f"[learning] encoders' device time a batch of {B}: ViT "
          f"{vit_ms:.2f} ms ({B * ops_v / vit_ms / 1e9:.1f} TFLOP/s), BERT "
          f"{bert_ms:.2f} ms ({B * ops_b / bert_ms / 1e9:.1f} TFLOP/s); "
          f"{(vit_ms + bert_ms) / bound_ms:.2f} x the fp32 bound "
          f"{bound_ms:.2f} ms; {N * (ops_v + ops_b) / 1e12:.1f} TFLOP for "
          f"all tasks, {N / B * (vit_ms + bert_ms) / 1e3:.2f} s of device "
          f"time ({smi})")
    return f_img, f_text


def learn_encoder_parity(bench, smi: str):
    """Step 2: the same paper-profile weights drawn on the CPU and copied
    to the card give the CPU's features of ENC_PARITY_TASKS tasks."""
    p = encoders.PROFILES[LEARN_PROFILE]
    cpu = init_params({"vit": encoders.vit_spec(p),
                       "bert": encoders.bert_spec(p)}, 0, device="cpu")
    gpu = _tree_map(lambda t: t.cuda(), cpu)
    idx = np.arange(ENC_PARITY_TASKS)
    imgs = torch.from_numpy(bench.tasks.images(idx, p.img_size))
    toks, masks = (torch.from_numpy(a) for a in
                   bench.tasks.texts(idx, p.text_len, p.bert_vocab))
    pairs = [
        ("ViT", encoders.vit_encode(cpu["vit"], imgs, p),
         encoders.vit_encode(gpu["vit"], imgs.cuda(), p)),
        ("BERT", encoders.bert_encode(cpu["bert"], toks, masks, p),
         encoders.bert_encode(gpu["bert"], toks.cuda(), masks.cuda(), p))]
    for name, want, got in pairs:
        rms = float(want.pow(2).mean().sqrt())
        err = float((got.cpu() - want).abs().max()) / rms
        check(err <= ENC_PARITY_RTOL, f"{name} features on the card are "
              f"{err:.2e} of their RMS from the CPU's (> {ENC_PARITY_RTOL})")
        print(f"[learning] {name} features of {ENC_PARITY_TASKS} tasks, "
              f"card vs CPU from the same weights: max |diff| {err:.2e} of "
              f"the RMS {rms:.4f} (tolerance {ENC_PARITY_RTOL}) ({smi})")


def learn_predictors(bench, f_img, f_text, smi: str):
    """Step 3: MILP and MGQP trained on the card at the "paper" budget
    (benchmarks/common.py:trained_predictors), with tests/test_core.py's
    checks; returns their predictions of every (task, class) pair."""
    tr, va, _ = splits(bench.tasks.n)
    train = flat_records(bench, f_text, f_img, tr)
    val = flat_records(bench, f_text, f_img, va)
    cfg = PredictorConfig(epochs=LEARN_EPOCHS, batch=256, seed=0)
    C = len(SERVER_CLASSES)
    allb = {"f_text": np.repeat(f_text, C, 0),
            "f_img": np.repeat(f_img, C, 0),
            "model_id": np.tile(bench.model_id, bench.tasks.n),
            "device_id": np.tile(bench.device_id, bench.tasks.n)}
    preds = {}
    for kind in ("latency", "quality"):
        model = Predictor(kind, 8, 8, cfg, feat_dim=f_text.shape[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = model.fit(train, val)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = cfg.epochs * (len(train["model_id"]) // cfg.batch)
        first, last = hist[0], hist[-1]
        check(last["train_loss"] < first["train_loss"],
              f"{kind}: train loss {first['train_loss']:.4f} -> "
              f"{last['train_loss']:.4f} did not fall")
        if kind == "quality":
            check(last["train_acc"] > 0.55,
                  f"MGQP train accuracy {last['train_acc']:.4f} <= 0.55")
            what = (f"train acc {last['train_acc']:.4f}, val acc "
                    f"{last['val_acc']:.4f}")
        else:
            lat = bench.latency_s[tr].reshape(-1)
            base = float(np.abs(lat - lat.mean()).mean())
            check(last["train_mae_s"] < base,
                  f"MILP train MAE {last['train_mae_s']:.4f} s is not below "
                  f"the mean predictor's {base:.4f} s")
            what = (f"train MAE {last['train_mae_s']:.4f} s (mean "
                    f"predictor {base:.4f} s), val MAE "
                    f"{last['val_mae_s']:.4f} s")
        name = "MGQP" if kind == "quality" else "MILP"
        print(f"[learning] {name}: {cfg.epochs} epochs of {len(tr)} x {C} "
              f"records, {steps} Adam steps in {secs:.2f} s "
              f"({steps / secs:.1f} steps/s, a train and a val evaluation "
              f"each epoch); train loss {first['train_loss']:.4f} -> "
              f"{last['train_loss']:.4f}; {what} ({smi})")
        preds[kind] = model.predict(allb).reshape(-1, C).astype(np.float32)
    return preds["latency"], preds["quality"]


def counted(agent) -> dict:
    """Count ``agent``'s acts, greedy ones (all through the network) apart,
    and its train steps, with the host seconds in each (each reads its
    result on the host, so the host clock holds the card's work)."""
    stats = dict.fromkeys(("act", "act_s", "greedy", "greedy_s", "trains",
                           "train_s"), 0)
    act, train_step = agent.act, agent.train_step

    def timed_act(state, greedy=False):
        t0 = time.perf_counter()
        a = act(state, greedy=greedy)
        key = "greedy" if greedy else "act"
        stats[key + "_s"] += time.perf_counter() - t0
        stats[key] += 1
        return a

    def timed_train(batch):
        t0 = time.perf_counter()
        loss = train_step(batch)
        stats["train_s"] += time.perf_counter() - t0
        stats["trains"] += 1
        return loss

    agent.act, agent.train_step = timed_act, timed_train
    return stats


def learn_qlmio(bench, f_img, f_text, milp, mgqp, smi: str):
    """Step 4: QLMIO from the learned predictions at
    examples/quickstart.py's budget, on the card, beside the heuristics
    (printed only: random frozen encoders are not the paper's)."""
    tr, _, te = splits(bench.tasks.n)
    servers = make_servers(QS_SERVERS, bench)
    q = QLMIO(bench, servers, (f_img, f_text), milp, mgqp,
              QLMIOConfig(episodes=QS_EPISODES, users=QS_USERS, seed=0,
                          agent=D3QNConfig(eps_decay_steps=QS_EPISODES
                                           * QS_USERS // 2)))
    stats = counted(q.agent)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = q.train(tr)
    secs = time.perf_counter() - t0
    res = q.evaluate(te, trials=QS_TRIALS)
    heur = evaluate_heuristics(bench, servers, te, QS_USERS, QS_TRIALS)
    check(all(np.isfinite(h["avg_reward"]) for h in hist),
          "QLMIO's episode rewards are not finite")
    print(f"[learning] QLMIO train: {QS_EPISODES} episodes of {QS_USERS} "
          f"users on {QS_SERVERS} servers in {secs:.2f} s; "
          f"{stats['act']} epsilon-greedy acts ({stats['act_s']:.2f} s, "
          f"{stats['act'] / stats['act_s']:.0f} acts/s); evaluate's "
          f"{stats['greedy']} greedy acts, each through the network "
          f"({stats['greedy'] / stats['greedy_s']:.0f} acts/s); "
          f"{stats['trains']} train steps of batch "
          f"{q.agent.cfg.batch} ({stats['train_s']:.2f} s, "
          f"{stats['trains'] / max(stats['train_s'], 1e-9):.1f} steps/s); "
          f"last episode reward {hist[-1]['avg_reward']:.4f}, epsilon "
          f"{hist[-1]['epsilon']:.3f} ({smi})")
    rows = [("QLMIO", res)] + list(heur.items())
    for name, r in rows:
        print(f"[learning] evaluate({QS_TRIALS} trials of {QS_USERS} users, "
              f"test split) {name:>9}: reward {r['avg_reward']:.4f}, "
              f"latency {r['avg_latency_s']:.4f} s, completion "
              f"{r['completion_rate']:.4f} ({smi})")
    return q


def learn_oracle_run(smi: str):
    """Step 5: tests/test_core.py:98-116's run on the card (oracle
    predictions, its "tiny" features drawn on the card) and its three
    assertions."""
    bench = generate(seed=0, n_tasks=ORACLE_TASKS)
    feats = compute_features(bench.tasks, profile=ORACLE_PROFILE,
                             cache_dir=None)
    tr, _, te = splits(bench.tasks.n)
    servers = make_servers(5, bench)
    q = QLMIO(bench, servers, feats, bench.latency_s.astype(np.float32),
              (bench.score == 1).astype(np.float32),
              QLMIOConfig(episodes=40, users=10, seed=0,
                          agent=D3QNConfig(eps_decay_steps=250, batch=64)))
    t0 = time.perf_counter()
    hist = q.train(tr)
    secs = time.perf_counter() - t0
    res = q.evaluate(te, trials=3)
    rnd = evaluate_heuristics(bench, servers, te, 10, 3)["random"]
    first = float(np.mean([h["avg_reward"] for h in hist[:10]]))
    last = float(np.mean([h["avg_reward"] for h in hist[-10:]]))
    check(res["avg_reward"] > rnd["avg_reward"],
          f"oracle QLMIO reward {res['avg_reward']:.4f} is not above "
          f"random's {rnd['avg_reward']:.4f}")
    check(res["completion_rate"] > rnd["completion_rate"],
          f"oracle QLMIO completion {res['completion_rate']:.4f} is not "
          f"above random's {rnd['completion_rate']:.4f}")
    check(last > first, f"oracle QLMIO did not learn: reward of the last "
          f"10 episodes {last:.4f}, of the first 10 {first:.4f}")
    print(f"[learning] test_core.py's oracle run on the card (40 episodes "
          f"of 10 users, {secs:.2f} s): reward {res['avg_reward']:.4f} vs "
          f"random {rnd['avg_reward']:.4f}, completion "
          f"{res['completion_rate']:.4f} vs {rnd['completion_rate']:.4f}; "
          f"mean episode reward {first:.4f} (first 10) -> {last:.4f} (last "
          f"10) ({smi})")


def hold_step(label, cpu_tree, gpu_tree, cpu_loss, gpu_loss, lr, smi: str):
    """One Adam step on the card against the CPU's from the same weights
    and batch: the loss, each leaf's gradient (of the network's largest)
    and each parameter (see STEP_GRAD_RTOL)."""
    check(abs(gpu_loss - cpu_loss) <= STEP_RTOL * abs(cpu_loss),
          f"{label}: loss {gpu_loss} on the card, {cpu_loss} on the CPU")
    cpu, gpu = tree_leaves(cpu_tree), tree_leaves(gpu_tree)
    s = max(float(t.grad.abs().max()) for t in cpu)
    grad_err = param_err = 0.0
    for c, g in zip(cpu, gpu):
        grad_err = max(grad_err,
                       float((g.grad.cpu() - c.grad).abs().max()) / s)
        share = (STEP_GRAD_RTOL * s / c.grad.abs().clamp_min(1e-30)
                 ).clamp_max(1.0)
        bound = 1e-6 + 2 * lr * share
        diff = (g.detach().cpu() - c.detach()).abs()
        check(bool((diff <= bound).all()), f"{label}: a parameter moved "
              f"{float((diff - bound).max()):.2e} past its bound on the card")
        param_err = max(param_err, float(diff.max()))
    check(grad_err <= STEP_RTOL, f"{label}: gradients on the card are "
          f"{grad_err:.2e} of the largest from the CPU's")
    print(f"[learning] one {label} step, card vs CPU from the same weights "
          f"and batch: loss {gpu_loss:.6f} vs {cpu_loss:.6f}, gradients "
          f"within {grad_err:.2e} of the largest ({s:.4f}), parameters "
          f"within {param_err:.2e} ({smi})")


def learn_step_parity(bench, f_img, f_text, q, smi: str):
    """Step 6: one Predictor step (dropout 0: the CPU's and the card's
    generators differ) and one D3QNAgent.train_step on a sample of step
    4's replay, each on the CPU and on the card from the same weights."""
    tr, _, _ = splits(bench.tasks.n)
    data = flat_records(bench, f_text, f_img, tr[:86])  # 258 records
    cfg = PredictorConfig(epochs=1, batch=256, dropout=0.0)
    pair = [Predictor("latency", 8, 8, cfg, f_text.shape[1], device=d)
            for d in ("cpu", "cuda")]
    copy_tree_(pair[1].params, pair[0].params)
    losses = [m.fit(data)[0]["train_loss"] for m in pair]
    hold_step("Predictor (MILP)", pair[0].params, pair[1].params, *losses,
              cfg.lr, smi)
    agents = [D3QNAgent(QS_SERVERS, q.agent.params["emb_model"].shape[0],
                        q.agent.params["emb_device"].shape[0],
                        feat_dim=f_text.shape[1], device=d)
              for d in ("cpu", "cuda")]
    copy_tree_(agents[1].params, agents[0].params)
    copy_tree_(agents[1].target, agents[0].target)
    batch = q.replay.sample(agents[0].cfg.batch, np.random.default_rng(0))
    losses = [a.train_step(batch) for a in agents]
    hold_step("D3QNAgent", agents[0].params, agents[1].params, *losses,
              agents[0].cfg.lr, smi)


def phase_learning(smi: str):
    """The paper's pipeline on the card (phase 9e): frozen encoders ->
    features of every task -> MILP/MGQP -> QLMIO against the heuristics;
    test_core.py's learning run; CPU/card parity of the encoders and of
    one training step.  It launches none of the port's kernels (the
    encoders' attention and LayerNorms are plain torch, as the JAX package
    computes them outside its Pallas kernels)."""
    for w in WRAPPERS.values():
        w.launches = 0
    bench = generate(seed=0, n_tasks=LEARN_TASKS)
    with timed("learning: features"):
        f_img, f_text = learn_features(bench, smi)
    with timed("learning: encoder parity"):
        learn_encoder_parity(bench, smi)
    with timed("learning: predictors"):
        milp, mgqp = learn_predictors(bench, f_img, f_text, smi)
    with timed("learning: QLMIO"):
        q = learn_qlmio(bench, f_img, f_text, milp, mgqp, smi)
    with timed("learning: oracle run"):
        learn_oracle_run(smi)
    with timed("learning: step parity"):
        learn_step_parity(bench, f_img, f_text, q, smi)
    launched = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    check(not launched, f"the learning pipeline launched {launched}")


# ------------------------------------------------------------- training

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT = 8, 1024, 8, 4
TRAIN_WARMUP = 2  # steps before the step times are read
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "smoke_train"
# the backward kernels against their plain backwards, as a fraction of
# each output's largest magnitude: fp32 the order of the sums; bf16 one
# rounding of each output to bf16 (from fp32 sums that differ in their
# last bits, which can round a value to its neighbour, 2^-8 of it)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# (label, B, Sq, Sk, H, Hkv, D, window, q_offset), all causal
FLASH_BWD_CASES = [
    ("qwen2-0.5b heads, S 1024", 2, 1024, 1024, 14, 2, 64, 0, None),
    ("llama3.2-3b heads, S 1024", 1, 1024, 1024, 24, 8, 128, 0, None),
    ("gemma3-1b local layer (window 512)", 1, 1024, 1024, 4, 1, 256, 512,
     None),
    ("gemma3-1b global layer", 1, 1024, 1024, 4, 1, 256, 0, None),
    ("ragged S 999", 2, 999, 999, 14, 2, 64, 0, None),
    ("suffix of 300 at q_offset 700 (Sk 1024)", 2, 300, 1024, 14, 2, 64, 0,
     700),
    ("reduced configs' D 16", 2, 64, 64, 4, 2, 16, 0, None),
    ("reduced gemma3-1b window 32", 2, 64, 64, 4, 1, 16, 32, None),
]
# RMSNorm backward: rows x (qwen2-0.5b 896, gemma3-1b 1152, 2048,
# llama3.2-3b 3072, gemma3-1b's qk-norm 256)
RMS_BWD_ROWS, RMS_BWD_WIDTHS = (1, 64, 8192), (896, 1152, 2048, 3072, 256)
# the grouped-matmul backward (label, E, C, K, N): granite-moe-1b-a400m's
# training capacity at B 8 x S 1024 (C 2560; gate/up and down),
# qwen2-moe-a2.7b's expert shape at C 688, a small C, and rows that TMA
# cannot describe (K 1020, N 510: not multiples of 16 bytes), which run
# the mma.sync tiles
GMM_BWD_CASES = [("granite-moe training gate/up", 32, 2560, 1024, 512),
                 ("granite-moe training down", 32, 2560, 512, 1024),
                 ("qwen2-moe expert shape", 60, 688, 2048, 1408),
                 ("small C", 16, 8, 1024, 512),
                 ("rows not 16-byte aligned", 8, 320, 1020, 510)]
# the SSD-scan backward (label, b, S, h, p, n, chunk, final-state
# gradient): zamba2-2.7b's width at B 4 x S 256 and S 1024, and a ragged
# last block with a final-state gradient
SCAN_BWD_CASES = [("zamba2 B 4 x S 256", 4, 256, 80, 64, 64, 256, False),
                  ("zamba2 B 4 x S 1024", 4, 1024, 80, 64, 64, 256, False),
                  ("ragged S 200, final-state gradient", 2, 200, 8, 64, 64,
                   200, True)]
# the flash backward at the new families' shapes (label, B, Sq, Sk, H,
# Hkv, D, causal): zamba2-2.7b's shared block (D 80), whisper-large-v3's
# encoder (1500 frames, non-causal), cross-attention (448 queries against
# them) and decoder (448, causal)
FLASH_BWD_FAMILY_CASES = [
    ("zamba2 shared block, B 4, S 1024", 4, 1024, 1024, 32, 32, 80, True),
    ("D 80, ragged S 999", 2, 999, 999, 32, 32, 80, True),
    ("whisper encoder, B 4, S 1500", 4, 1500, 1500, 20, 20, 64, False),
    ("whisper cross, B 4, 448 x 1500", 4, 448, 1500, 20, 20, 64, False),
    ("whisper decoder, B 4, S 448", 4, 448, 448, 20, 20, 64, True)]
# row 11's bf16 shapes in phase 4 (label, B, Sq, Sk, H, Hkv, D, causal,
# window): qwen2-0.5b's training shape, whisper-large-v3's encoder,
# zamba2-2.7b's shared block and gemma3-1b's global and local layers
FLASH_BWD_ROWS = [
    ("qwen2-0.5b training, B 8, S 1024", 8, 1024, 1024, 14, 2, 64, True, 0),
    ("whisper encoder, B 4, S 1500", 4, 1500, 1500, 20, 20, 64, False, 0),
    ("zamba2 shared block, B 4, S 1024", 4, 1024, 1024, 32, 32, 80, True,
     0),
    ("gemma3-1b global layer, B 2, S 1024", 2, 1024, 1024, 4, 1, 256, True,
     0),
    ("gemma3-1b local layer, B 2, S 1024", 2, 1024, 1024, 4, 1, 256, True,
     512)]
TRAIN_PARITY = ("qwen2-0.5b", "gemma3-1b", "granite-moe-1b-a400m",
                "qwen2-moe-a2.7b", "zamba2-2.7b", "xlstm-1.3b",
                "whisper-large-v3")  # reduced, fp32
# reduced zamba2 and xlstm scan 64 tokens in chunks of 16
PARITY_OVERRIDES = {"zamba2-2.7b": {"scan_chunk": 16},
                    "xlstm-1.3b": {"scan_chunk": 16}}
# the families whose fp32 gradients the CPU itself does not give to
# TRAIN_GRAD_REL: reduced zamba2's CPU run is 1.12e-5 (the embedding) and
# 1.73e-5 (conv_b) of each leaf's largest |g| from a float64 run (my CPU
# run).  A leaf of theirs past TRAIN_GRAD_REL from the CPU's passes where
# the CPU's own error is over half the bound and the card's, against the
# float64 run, is at most twice the CPU's.
FP32_HELD = ("zamba2-2.7b",)
TRAIN_GRAD_REL = 1e-5  # of each gradient leaf's largest |g|
ADAM_PARAM_ATOL, ADAM_GRAD_REL = 1e-6, 1e-5  # test_torch_core_qlmio.py's


def visible_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """(query, key) pairs a mask leaves visible, per (batch, head)."""
    qpos = (Sk - Sq if q_offset is None else q_offset) + np.arange(Sq)
    kpos = np.arange(Sk)
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= kpos[None] <= qpos[:, None]
    if window:
        live &= qpos[:, None] - kpos[None] < window
    return int(live.sum())


def flash_bwd_inputs(B, Sq, Sk, H, Hkv, D, dt, window, q_offset,
                     causal=True):
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, H, D, device=dev, dtype=dt)
    k = torch.randn(B, Sk, Hkv, D, device=dev, dtype=dt)
    v = torch.randn(B, Sk, Hkv, D, device=dev, dtype=dt)
    do = torch.randn(B, Sq, H, D, device=dev, dtype=dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, return_lse=True,
                                                 **kw)
    return (q, k, v, o, lse, do), kw


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def hold_bwd(label, got, want, dt) -> float:
    """Each output within BWD_TOL[dt] of its plain version's largest
    magnitude; returns the largest |error|."""
    worst = 0.0
    for a, w in zip(got, want):
        err = rel_err(a, w)
        check(err <= BWD_TOL[dt], f"{label}: {err:.3g} of the plain "
              f"version's largest magnitude, over {BWD_TOL[dt]:.3g}")
        worst = max(worst, float((a.float() - w.float()).abs().max()))
    return worst


def phase_train_compare() -> dict:
    """Phase 3's backward cases: the flash-attention backward kernel and
    the RMSNorm backward kernels against their plain backwards on the
    same inputs, in bf16 and fp32, two calls bit-equal; the forward's lse
    against the plain version's.  Returns the largest error per kernel."""
    worst = {"flash_attention_bwd": 0.0, "rmsnorm_bwd": 0.0}
    for (label, B, Sq, Sk, H, Hkv, D, window, q_offset), dt in \
            itertools.product(FLASH_BWD_CASES,
                              (torch.bfloat16, torch.float32)):
        args, kw = flash_bwd_inputs(B, Sq, Sk, H, Hkv, D, dt, window,
                                    q_offset)
        _, lse = flash_attention_ref(*args[:3], return_lse=True, **kw)
        lse_err = float((args[4] - lse).abs().max())
        check(lse_err <= 1e-4, f"flash lse, {label}: {lse_err:.3g}")
        got = flash_attention.flash_attention_bwd(*args, **kw)
        again = flash_attention.flash_attention_bwd(*args, **kw)
        want = flash_attention.flash_attention_bwd_ref(*args, **kw)
        check(all(map(torch.equal, got, again)),
              f"flash backward, {label}: two calls differ")
        err = hold_bwd(f"flash backward, {label}, {str(dt)[6:]}", got, want,
                       dt)
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], err)
        print(f"[compare] flash attention backward, {label} (B {B}, Sq {Sq},"
              f" Sk {Sk}, heads {H}/{Hkv}, D {D}), {str(dt)[6:]}: dq/dk/dv "
              + "/".join(f"{rel_err(a, w):.2e}" for a, w in zip(got, want))
              + f" of the largest magnitude, lse {lse_err:.2e}; two calls "
              "bit-equal")
        del args, got, again, want
    errs = []
    for rows, d, zc, dt in itertools.product(
            RMS_BWD_ROWS, RMS_BWD_WIDTHS, (False, True),
            (torch.bfloat16, torch.float32)):
        x = torch.randn(rows, d, device="cuda", dtype=dt)
        dy = torch.randn(rows, d, device="cuda", dtype=dt)
        s = (1 + 0.5 * torch.randn(d, device="cuda")).to(dt)
        got = rms_kernel.rmsnorm_bwd(x, s, dy, zero_centered=zc)
        again = rms_kernel.rmsnorm_bwd(x, s, dy, zero_centered=zc)
        want = rms_kernel.rmsnorm_bwd_ref(x, s, dy, zero_centered=zc)
        check(all(map(torch.equal, got, again)),
              f"rmsnorm backward [{rows}, {d}]: two calls differ")
        err = hold_bwd(f"rmsnorm backward [{rows}, {d}] zero-centred {zc} "
                       f"{str(dt)[6:]}", got, want, dt)
        worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], err)
        errs.append(max(rel_err(a, w) for a, w in zip(got, want)))
    print(f"[compare] rmsnorm backward: {len(errs)} cases (rows "
          f"{RMS_BWD_ROWS}, d {RMS_BWD_WIDTHS}, zero-centred or not, bf16 "
          f"and fp32), dx and dscale within {max(errs):.2e} of the largest "
          "magnitude; two calls bit-equal")
    for name, err in compare_family_backwards().items():
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _hold_twice(label, fn, ref, dt) -> float:
    """``fn()`` twice (bit-equal) and within BWD_TOL[dt] of ``ref()``;
    prints each output's error; returns the largest |error|."""
    got, again = fn(), fn()
    check(all(map(torch.equal, got, again)), f"{label}: two calls differ")
    want = ref()
    err = hold_bwd(f"{label}, {str(dt)[6:]}", got, want, dt)
    print(f"[compare] {label}, {str(dt)[6:]}: " + "/".join(
        f"{rel_err(a, w):.2e}" for a, w in zip(got, want))
        + " of the largest magnitude; two calls bit-equal")
    return err


def compare_family_backwards() -> dict:
    """Phase 3's cases of the new families' backwards, bf16 and fp32: the
    grouped-matmul backward (dx/dw) at ``GMM_BWD_CASES``, the SSD-scan
    backward (dx/ddt/da_neg/dB/dC) at ``SCAN_BWD_CASES`` and the flash
    backward (dq/dk/dv) at ``FLASH_BWD_FAMILY_CASES``, each against its
    plain backward on the same inputs within BWD_TOL, two calls bit-equal;
    then one call of each new wrapper under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns the largest
    error per kernel."""
    dev = torch.device("cuda")
    worst = {"grouped_matmul_bwd": 0.0, "ssd_scan_bwd": 0.0}
    for (label, E, C, K, N), dt in itertools.product(
            GMM_BWD_CASES, (torch.bfloat16, torch.float32)):
        x, w, dy = (torch.randn(s, device=dev, dtype=dt)
                    for s in ((E, C, K), (E, K, N), (E, C, N)))
        err = _hold_twice(
            f"grouped matmul backward, {label} (E {E}, C {C}, K {K}, N {N}; "
            f"{moe_gmm.bwd_variant(dt, K, N)})",
            lambda: moe_gmm.grouped_matmul_bwd(x, w, dy),
            lambda: moe_gmm.grouped_matmul_bwd_ref(x, w, dy), dt)
        worst["grouped_matmul_bwd"] = max(worst["grouped_matmul_bwd"], err)
        del x, w, dy
    for (label, b, S, h, p, n, Q, final), dt in itertools.product(
            SCAN_BWD_CASES, (torch.bfloat16, torch.float32)):
        args = scan_bwd_inputs(b, S, h, p, n, dt, final)
        err = _hold_twice(
            f"ssd scan backward, {label} (b {b}, S {S}, {h} heads of {p}, "
            f"state {n}, chunk {Q}; {scan_kernel.bwd_variant(dt, p, n)})",
            lambda: scan_kernel.ssd_scan_bwd(*args, chunk=Q),
            lambda: scan_kernel.ssd_scan_bwd_ref(*args, chunk=Q), dt)
        worst["ssd_scan_bwd"] = max(worst["ssd_scan_bwd"], err)
        del args
    for (label, B, Sq, Sk, H, Hkv, D, causal), dt in itertools.product(
            FLASH_BWD_FAMILY_CASES, (torch.bfloat16, torch.float32)):
        args, kw = flash_bwd_inputs(B, Sq, Sk, H, Hkv, D, dt, 0, None,
                                    causal=causal)
        err = _hold_twice(
            f"flash attention backward, {label} (heads {H}/{Hkv}, D {D}, "
            f"{'causal' if causal else 'non-causal'})",
            lambda: flash_attention.flash_attention_bwd(*args, **kw),
            lambda: flash_attention.flash_attention_bwd_ref(*args, **kw), dt)
        worst["flash_attention_bwd"] = max(
            worst.get("flash_attention_bwd", 0.0), err)
        del args
        torch.cuda.empty_cache()
    x, w, dy = (torch.randn(s, device=dev, dtype=torch.bfloat16)
                for s in ((8, 64, 128), (8, 128, 96), (8, 64, 96)))
    sargs = scan_bwd_inputs(1, 128, 4, 16, 8, torch.bfloat16, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_gmm.grouped_matmul_bwd(x, w, dy)
        scan_kernel.ssd_scan_bwd(*sargs, chunk=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[compare] the grouped-matmul and SSD-scan backward wrappers "
          "issue no host sync (sync debug mode \"error\")")
    return worst


def scan_bwd_inputs(b, S, h, p, n, dt, final):
    """The SSD-scan backward's inputs on the card: x, B, C in ``dt``, dt
    in (0.01, 0.21) and a_neg in (-2.5, -0.5) fp32 (zamba2's ranges), y's
    gradient and, with ``final``, the final state's, fp32."""
    dev = torch.device("cuda")
    return (torch.randn(b, S, h, p, device=dev).to(dt),
            torch.rand(b, S, h, device=dev) * 0.2 + 0.01,
            -torch.rand(h, device=dev) * 2 - 0.5,
            torch.randn(b, S, n, device=dev).to(dt),
            torch.randn(b, S, n, device=dev).to(dt),
            torch.randn(b, S, h, p, device=dev),
            torch.randn(b, h, p, n, device=dev) if final else None)


def _time_bwd(name, label, fn, plain, library, nbytes, nops, dt, smi,
              err, device: bool) -> dict:
    """A backward kernel's row: ``fn(i)``, its plain backward and one
    library backward (a yardstick the port never calls) at one shape;
    with ``device``, also the kernel's and the library's device times
    (``device_ms``: three profiler sessions each, the phase's main
    cost)."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = nops / PEAK_OPS_PER_S[dt]
    split: dict = {}
    row = {"ms": cuda_ms(fn, 48),
           "device_ms": device_ms(fn, 10, split) if device else None,
           "plain_ms": cuda_ms(plain, 3, warmup=1),
           "library_ms": cuda_ms(library, 48) if library else None,
           "library_device_ms": (device_ms(library, 10)
                                 if device and library else None),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "main_shapes_max_abs_err": err}
    dev = ("", "", "")
    if device:
        dev = (f" (device {row['device_ms']:.4f} ms)",
               f" (device {row['library_device_ms']:.4f} ms)"
               if library else "",
               f" ({row['bound_ms'] / row['device_ms']:.2%} by device time)")
    lib = (f"library {row['library_ms']:.4f} ms{dev[1]}" if library
           else "no library call computes it")
    print(f"[timing] {name} ({label}): kernel {row['ms']:.4f} ms{dev[0]}, "
          f"plain {row['plain_ms']:.4f} ms, {lib}, "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"{nbytes} bytes, {nops} operations at the {str(dt)[6:]} peak), "
          f"{row['bound_ms'] / row['ms']:.2%} of bound{dev[2]} ({smi})")
    if len(split) > 1:
        print(f"[timing]   {name} ({label}) device time by kernel: " +
              "; ".join(f"{_short(key)} {ms:.4f} ms"
                        for key, ms in split.items()))
    return row


def phase_train_timing(smi: str) -> dict:
    """Phase 4's training rows.  The flash-attention backward at
    qwen2-0.5b's training shape (B 8, S 1024, 14/2 heads of 64, causal,
    bf16; the kernels-line entry) and gemma3-1b's local and global layers
    (B 2, S 1024, 4/1 heads of 256), against ``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention`` (``is_causal``, ``enable_gqa``, on
    [B, H, S, D] copies; the backward alone); its bound is 5 products of
    the visible pairs (s, dp, dv, dk, dq: 2 flops a multiply-add) at the
    inputs' type's peak, or q, k, v, o, do, lse read and dq, dk, dv
    written once.  The RMSNorm backward at qwen2-0.5b's [8192, 896] (the
    kernels-line entry) and gemma3-1b's [8192, 1152] and qk-norm rows
    [32768, 256], bf16, against ``F.rms_norm``'s backward; bytes bound
    it.  Device times (``device_ms``) only at the two kernels-line
    shapes.  And the forward kernel at the training shape without and
    with its lse output, twice each in turn (CUDA events)."""
    out = {}
    for label, B, H, Hkv, D, window in (
            ("qwen2-0.5b training, B 8, S 1024", 8, 14, 2, 64, 0),
            ("gemma3-1b local layer, B 2, S 1024", 2, 4, 1, 256, 512),
            ("gemma3-1b global layer, B 2, S 1024", 2, 4, 1, 256, 0)):
        dt, S = torch.bfloat16, TRAIN_S
        args, kw = flash_bwd_inputs(B, S, S, H, Hkv, D, dt, window, None)
        q, k, v, o, lse, do = args
        got = flash_attention.flash_attention_bwd(*args, **kw)
        want = flash_attention.flash_attention_bwd_ref(*args, **kw)
        err = hold_bwd(f"flash backward, {label}", got, want, dt)
        del got, want
        library = sdpa_backward(q, k, v, do, True, window)
        pairs = B * visible_pairs(S, S, True, window, None)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        row = _time_bwd(
            "flash_attention_bwd", f"{label}, heads {H}/{Hkv}, D {D}"
            + (f", window {window}" if window else ""),
            lambda i=0: flash_attention.flash_attention_bwd(*args, **kw),
            lambda i=0: flash_attention.flash_attention_bwd_ref(*args, **kw),
            library, nbytes, 5 * 2 * pairs * H * D, dt, smi, err,
            device=B == TRAIN_B)
        out.setdefault("flash_attention_bwd", row)
        if B == TRAIN_B:
            for with_lse in (False, True, False, True):
                ms = cuda_ms(lambda i=0: flash_attention.flash_attention_fwd(
                    q, k, v, return_lse=with_lse), 48)
                print(f"[timing] flash_attention forward ({label}) "
                      f"{'with' if with_lse else 'without'} lse: {ms:.4f} ms "
                      f"({smi})")
        del args, q, k, v, o, lse, do, library
    for label, shape in (("qwen2-0.5b training", (8192, 896)),
                         ("gemma3-1b training", (8192, 1152)),
                         ("gemma3-1b qk-norm", (32768, 256))):
        dt = torch.bfloat16
        x = torch.randn(shape, device="cuda", dtype=dt)
        dy = torch.randn(shape, device="cuda", dtype=dt)
        s = (1 + 0.5 * torch.randn(shape[-1], device="cuda")).to(dt)
        got = rms_kernel.rmsnorm_bwd(x, s, dy)
        err = hold_bwd(f"rmsnorm backward, {label}", got,
                       rms_kernel.rmsnorm_bwd_ref(x, s, dy), dt)
        xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
        yl = F.rms_norm(xl, (shape[-1],), weight=sl, eps=1e-6)

        def library(i=0, yl=yl, xl=xl, sl=sl, dy=dy):
            torch.autograd.grad(yl, (xl, sl), dy, retain_graph=True)

        row = _time_bwd(
            "rmsnorm_bwd", f"{label} {list(shape)} bf16",
            lambda i=0: rms_kernel.rmsnorm_bwd(x, s, dy),
            lambda i=0: rms_kernel.rmsnorm_bwd_ref(x, s, dy), library,
            3 * x.numel() * x.element_size() + 2 * s.numel() * 2,
            10 * x.numel(), dt, smi, err, device=shape == (8192, 896))
        out.setdefault("rmsnorm_bwd", row)
    out.update(time_family_backwards(smi))
    return out


def scan_bwd_ops(b, S, h, p, n, Q) -> int:
    """Operations of the SSD-scan backward in blocks of ``bwd_block(Q)``
    tokens (the kernel's cut): per (batch, head, block) the causal pairs'
    CB, DX and the pair sums of dxd, dC and dB (2 (3 n + 2 p) a pair), per
    token the state terms (own, gown, G B, dy S, xd G: 10 p n)."""
    T = scan_kernel.bwd_block(Q)
    pairs = sum(t * (t + 1) // 2 for t in
                [T] * (S // T) + ([S % T] if S % T else []))
    return b * h * (pairs * 2 * (3 * n + 2 * p) + S * 10 * p * n)


def time_family_backwards(smi: str) -> dict:
    """Phase 4's rows of the new families' backwards, bf16.  The
    grouped-matmul backward at granite-moe's training capacity (C 2560;
    gate/up, the kernels-line entry, also by device time, and down) and
    qwen2-moe's expert shape, against the two ``torch.bmm`` calls that
    compute dx and dw; its bound is 4 E C K N operations at the bf16 peak,
    or x, w, dy read and dx, dw written once.  The SSD-scan backward at
    zamba2-2.7b's B 4 x S 1024 (the kernels-line entry, also by device
    time) and S 256, which no single PyTorch call computes; its bound is
    ``scan_bwd_ops`` at the bf16 peak or x, dt, B, C, dy read and dx, ddt,
    dB, dC written once.  The flash backward at zamba2's shared block (D
    80) and whisper's encoder and cross-attention shapes against SDPA's
    backward (as phase 4's qwen2-0.5b row)."""
    dev, dt = torch.device("cuda"), torch.bfloat16
    out = {}
    for i, (label, E, C, K, N) in enumerate(GMM_BWD_CASES[:3]):
        x, w, dy = (torch.randn(s, device=dev, dtype=dt)
                    for s in ((E, C, K), (E, K, N), (E, C, N)))
        got = moe_gmm.grouped_matmul_bwd(x, w, dy)
        err = hold_bwd(f"grouped matmul backward, {label}", got,
                       moe_gmm.grouped_matmul_bwd_ref(x, w, dy), dt)
        del got

        def library(i=0, x=x, w=w, dy=dy):
            torch.bmm(dy, w.transpose(1, 2))
            torch.bmm(x.transpose(1, 2), dy)

        row = _time_bwd(
            "grouped_matmul_bwd", f"{label}, E {E}, C {C}, K {K}, N {N}, "
            "bf16", lambda i=0, x=x, w=w, dy=dy:
            moe_gmm.grouped_matmul_bwd(x, w, dy),
            lambda i=0, x=x, w=w, dy=dy:
            moe_gmm.grouped_matmul_bwd_ref(x, w, dy), library,
            2 * (2 * E * C * K + 2 * E * K * N + E * C * N),
            4 * E * C * K * N, dt, smi, err, device=i == 0)
        out.setdefault("grouped_matmul_bwd", row)
        del x, w, dy
    for label, b, S, h, p, n, Q, final in (SCAN_BWD_CASES[1],
                                           SCAN_BWD_CASES[0]):
        args = scan_bwd_inputs(b, S, h, p, n, dt, final)
        got = scan_kernel.ssd_scan_bwd(*args, chunk=Q)
        err = hold_bwd(f"ssd scan backward, {label}", got,
                       scan_kernel.ssd_scan_bwd_ref(*args, chunk=Q), dt)
        del got
        nbytes = b * S * (h * p * (2 + 4 + 2) + h * (4 + 4) + 4 * n * 2)
        row = _time_bwd(
            "ssd_scan_bwd", f"{label}, {h} heads of {p}, state {n}, bf16 x",
            lambda i=0, a=args: scan_kernel.ssd_scan_bwd(*a, chunk=Q),
            lambda i=0, a=args: scan_kernel.ssd_scan_bwd_ref(*a, chunk=Q),
            None, nbytes, scan_bwd_ops(b, S, h, p, n, Q), dt, smi, err,
            device=S == 1024)
        out.setdefault("ssd_scan_bwd", row)
        del args
    for label, B, Sq, Sk, H, Hkv, D, causal in FLASH_BWD_FAMILY_CASES[::2]:
        args, kw = flash_bwd_inputs(B, Sq, Sk, H, Hkv, D, dt, 0, None,
                                    causal=causal)
        q, k, v, o, lse, do = args
        got = flash_attention.flash_attention_bwd(*args, **kw)
        err = hold_bwd(f"flash backward, {label}", got,
                       flash_attention.flash_attention_bwd_ref(*args, **kw),
                       dt)
        del got
        library = sdpa_backward(q, k, v, do, causal, 0)
        pairs = B * visible_pairs(Sq, Sk, causal, 0, None)
        _time_bwd("flash_attention_bwd", f"{label}, heads {H}/{Hkv}, D {D}",
                  lambda i=0: flash_attention.flash_attention_bwd(*args,
                                                                   **kw),
                  lambda i=0: flash_attention.flash_attention_bwd_ref(
                      *args, **kw), library,
                  (4 * q.numel() + 4 * k.numel()) * q.element_size()
                  + lse.numel() * 4, 5 * 2 * pairs * H * D, dt, smi, err,
                  device=False)
        del args, q, k, v, o, lse, do, library
        torch.cuda.empty_cache()
    compare_gmm_bwd_parent(smi)
    compare_scan_bwd_parent(smi)
    compare_flash_bwd_parent(smi)
    return out


def gmm_bwd_parent(x, w, dy):
    """The bf16 grouped-matmul backward's first version, the mma.sync tiles
    the wgmma kernel replaced (``grouped_matmul_bwd_launch_mma_sync`` in
    the same library, two kernels): phase 4's yardstick, which the port
    never calls."""
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    E, C, K = x.shape
    N = w.shape[2]
    err = moe_gmm._bwd_lib().grouped_matmul_bwd_launch_mma_sync(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), E, C, K, N, moe_gmm._rows_aligned(x),
        moe_gmm._rows_aligned(w), moe_gmm._rows_aligned(dy),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the parent's grouped-matmul backward: error {err}")
    return dx, dw


def scan_bwd_parent(x, dt, a_neg, B, C, dy, dfinal=None, *, chunk):
    """The bf16 SSD-scan backward's first version, the four CUDA-core passes
    (``ssd_scan_bwd_launch_cuda_cores`` in the same library): phase 4's
    yardstick, which the port never calls."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    Q = scan_kernel.chunk_length(S, chunk)
    out = [torch.empty_like(t) for t in (x, dt, a_neg, B, C)]
    scratch = torch.empty(scan_kernel.bwd_scratch_bytes(b, S, h, p, n, Q)
                          // 4, dtype=torch.float32, device=x.device)
    err = scan_kernel._bwd_lib().ssd_scan_bwd_launch_cuda_cores(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), B.data_ptr(),
        C.data_ptr(), None, dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(),
        *(t.data_ptr() for t in out), scratch.data_ptr(), b, S, h, p, n, Q,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the parent's SSD-scan backward: error {err}")
    return tuple(out)


def _in_turn(label, kernel, parent, bound, library, smi):
    """Device time (``device_ms``) of the parent and the kernel in turn,
    parent, kernel, kernel, parent, beside ``library`` (one PyTorch call's
    device time, or None) and the bound; prints one line and the kernel's
    split by kernel; returns (kernel, parent) ms, each the mean of its
    two readings."""
    split: dict = {}
    ms = [device_ms(fn, 10, split if fn is kernel else None)
          for fn in (parent, kernel, kernel, parent)]
    old, new = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    lib = "" if library is None else (
        f"; two torch.bmm {library:.4f} ms (the kernel {new / library:.2f}x "
        "it)")
    print(f"[timing] {label}, device time in turn: parent {ms[0]:.4f} ms, "
          f"kernel {ms[1]:.4f} ms, kernel {ms[2]:.4f} ms, parent "
          f"{ms[3]:.4f} ms ({old / new:.2f}x faster){lib}; bound "
          f"{bound:.5f} ms, the kernel {bound / new:.2%} of it, the parent "
          f"{bound / old:.2%} ({smi})")
    print(f"[timing]   {label}, the kernel by kernel: " + "; ".join(
        f"{_short(key)} {v:.4f} ms" for key, v in split.items()))
    return new, old


def compare_gmm_bwd_parent(smi: str):
    """Phase 4's row-13 comparison: at each of the first three
    GMM_BWD_CASES in bf16 (granite-moe's gate/up and down at C 2560,
    qwen2-moe's expert shape), the parent's mma.sync tiles
    (``gmm_bwd_parent``) and the wgmma kernel, both first held to the
    plain backward within BWD_TOL, then by device time in turn beside the
    two ``torch.bmm`` calls that compute dx and dw and the bound (4 E C K
    N operations at the bf16 peak)."""
    dt = torch.bfloat16
    for label, E, C, K, N in GMM_BWD_CASES[:3]:
        x, w, dy = (torch.randn(s, device="cuda", dtype=dt)
                    for s in ((E, C, K), (E, K, N), (E, C, N)))
        want = moe_gmm.grouped_matmul_bwd_ref(x, w, dy)
        for fn in (gmm_bwd_parent, moe_gmm.grouped_matmul_bwd):
            hold_bwd(f"{fn.__name__}, {label}", fn(x, w, dy), want, dt)
        del want

        def kernel(i=0):
            moe_gmm.grouped_matmul_bwd(x, w, dy)

        def parent(i=0):
            gmm_bwd_parent(x, w, dy)

        def bmm(i=0):
            torch.bmm(dy, w.transpose(1, 2))
            torch.bmm(x.transpose(1, 2), dy)

        _in_turn(f"grouped_matmul_bwd, row 13, {label} (E {E}, C {C}, K {K},"
                 f" N {N}, bf16; {moe_gmm.bwd_variant(dt, K, N)})", kernel,
                 parent, 4 * E * C * K * N / PEAK_OPS_PER_S[dt] * 1e3,
                 device_ms(bmm, 10), smi)
        del x, w, dy
        torch.cuda.empty_cache()


def compare_scan_bwd_parent(smi: str):
    """Phase 4's row-14 comparison: zamba2-2.7b's B 4 x S 1024 and S 256
    (80 heads of 64, state 64, chunk 256, bf16 x), the parent's CUDA-core
    passes (``scan_bwd_parent``) and the tensor-core passes, both first
    held to the plain backward within BWD_TOL, then by device time in turn
    beside the bound (``scan_bwd_ops`` at the bf16 peak, or the bytes); no
    single PyTorch call computes it."""
    dt = torch.bfloat16
    for label, b, S, h, p, n, Q, final in (SCAN_BWD_CASES[1],
                                           SCAN_BWD_CASES[0]):
        args = scan_bwd_inputs(b, S, h, p, n, dt, final)
        want = scan_kernel.ssd_scan_bwd_ref(*args, chunk=Q)
        hold_bwd(f"the parent's SSD backward, {label}",
                 scan_bwd_parent(*args, chunk=Q), want, dt)
        hold_bwd(f"ssd_scan_bwd, {label}",
                 scan_kernel.ssd_scan_bwd(*args, chunk=Q), want, dt)
        del want

        def kernel(i=0):
            scan_kernel.ssd_scan_bwd(*args, chunk=Q)

        def parent(i=0):
            scan_bwd_parent(*args, chunk=Q)

        nbytes = b * S * (h * p * (2 + 4 + 2) + h * (4 + 4) + 4 * n * 2)
        bound = max(nbytes / HBM_BYTES_PER_S, scan_bwd_ops(b, S, h, p, n, Q)
                    / PEAK_OPS_PER_S[dt]) * 1e3
        _in_turn(f"ssd_scan_bwd, row 14, {label} ({h} heads of {p}, state "
                 f"{n}, chunk {Q}, bf16 x; "
                 f"{scan_kernel.bwd_variant(dt, p, n)})", kernel, parent,
                 bound, None, smi)
        del args
        torch.cuda.empty_cache()


def sdpa_backward(q, k, v, do, causal, window):
    """One PyTorch call's backward at the flash backward's shape, its
    yardstick (the port never calls it): ``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention`` on [B, H, S, D] copies
    (``enable_gqa`` where H > Hkv; a window, Sq = Sk, as a boolean mask)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = None
    if window:
        pos = torch.arange(q.shape[1], device=q.device)
        mask = (pos[None] <= pos[:, None]) & \
            (pos[:, None] - pos[None] < window)
    ot = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=q.shape[2] != k.shape[2])
    dot = do.transpose(1, 2).contiguous()

    def library(i=0):
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    return library


def flash_bwd_parent(q, k, v, o, lse, do, *, causal=True, window=0,
                     q_offset=None):
    """The bf16 flash backward's first version, the CUDA-core kernels the
    tensor-core kernels replaced (``flash_attention_bwd_launch_cuda_cores``
    in the same library): phase 4's yardstick, which the port never
    calls."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    err = flash_attention._bwd_lib().flash_attention_bwd_launch_cuda_cores(
        flash_attention.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq,
        Sk, H, Hkv, D, int(causal), int(window),
        int(flash_attention._offset(q, k, causal, q_offset)), D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the parent's flash backward: error {err}")
    return dq, dk, dv


def compare_flash_bwd_parent(smi: str):
    """Phase 4's row-11 comparison: at each of FLASH_BWD_ROWS in bf16, the
    parent's kernels (``flash_bwd_parent``) and the tensor-core kernels,
    both first held to the plain backward within BWD_TOL, then by device
    time (``device_ms``) in turn, parent, kernel, kernel, parent, beside
    SDPA's backward's device time and the bound (5 products of the visible
    pairs at the bf16 peak, or q, k, v, o, do, lse read and dq, dk, dv
    written once)."""
    dt = torch.bfloat16
    for label, B, Sq, Sk, H, Hkv, D, causal, window in FLASH_BWD_ROWS:
        args, kw = flash_bwd_inputs(B, Sq, Sk, H, Hkv, D, dt, window, None,
                                    causal=causal)
        q, k, v, o, lse, do = args
        want = flash_attention.flash_attention_bwd_ref(*args, **kw)
        for fn in (flash_bwd_parent, flash_attention.flash_attention_bwd):
            hold_bwd(f"{fn.__name__}, {label}", fn(*args, **kw), want, dt)
        del want

        def kernel(i=0):
            flash_attention.flash_attention_bwd(*args, **kw)

        def parent(i=0):
            flash_bwd_parent(*args, **kw)

        ms = [device_ms(fn, 10) for fn in (parent, kernel, kernel, parent)]
        lib_ms = device_ms(sdpa_backward(q, k, v, do, causal, window), 10)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
            + lse.numel() * 4
        nops = 5 * 2 * B * visible_pairs(Sq, Sk, causal, window, None) * H * D
        bound = max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[dt]) * 1e3
        old, new = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        print(f"[timing] flash_attention_bwd, row 11, {label} (heads "
              f"{H}/{Hkv}, D {D}{f', window {window}' if window else ''}, "
              f"splits {flash_attention.bwd_plan(B, Sq, Sk, H, Hkv, D)}), "
              f"device time in turn: parent {ms[0]:.4f} ms, kernel "
              f"{ms[1]:.4f} ms, kernel {ms[2]:.4f} ms, parent {ms[3]:.4f} "
              f"ms ({old / new:.2f}x faster); SDPA backward {lib_ms:.4f} ms "
              f"(the kernel {new / lib_ms:.2f}x it); bound {bound:.5f} ms, "
              f"the kernel {bound / new:.2%} of it, the parent "
              f"{bound / old:.2%} ({smi})")
        del args, q, k, v, o, lse, do
        torch.cuda.empty_cache()


# the wrappers of the training path, each counting its forward launches
# (``launches``) and its backward calls (``bwd_launches``)
TRAIN_WRAPPERS = {"flash_attention": ops.flash_attention,
                  "rmsnorm": ops.rmsnorm,
                  "grouped_matmul": ops.grouped_matmul,
                  "ssd_scan": ops.ssd_scan}
BWD_NAMES = {name + "_bwd" for name in TRAIN_WRAPPERS}


def _counts() -> dict:
    out = {}
    for name, w in TRAIN_WRAPPERS.items():
        out[name] = w.launches
        out[name + "_bwd"] = w.bwd_launches
    return out


def zero_train_counts():
    for w in TRAIN_WRAPPERS.values():
        w.launches = w.bwd_launches = 0


def zero_bwd_counts():
    for w in TRAIN_WRAPPERS.values():
        w.bwd_launches = 0


def hold_no_backward():
    """No serving phase launched a backward kernel: the backward counts,
    set to 0 after phase 4, are still 0."""
    now = {k: v for k, v in _counts().items() if k in BWD_NAMES}
    check(not any(now.values()),
          f"a serving phase launched a backward kernel: {now}")
    print("[train] no serving phase launched a backward kernel")


def family_train_launches(cfg) -> dict:
    """Launches of one training step of ``cfg`` under remat (each wrapper
    counts one a call): a recomputed block runs its forward twice and its
    backward once, the rest once each way.  Attention family (dense or
    MoE): every layer recomputed, three grouped matmuls a MoE layer call;
    zamba2: the Mamba2 layers recomputed (a scan and 2 norms each), the
    shared block (flash attention and 2 norms) not; xlstm: the mLSTM
    blocks recomputed (2 norms each), the sLSTM blocks (3 norms) not;
    whisper: every encoder layer (one flash attention) and decoder layer
    (two) recomputed, its LayerNorms plain; the final norm once."""
    want = dict.fromkeys(_counts(), 0)

    def add(name, fwd, bwd):
        want[name] += fwd
        want[name + "_bwd"] += bwd

    if cfg.cross_attention:
        n = cfg.encoder_layers + 2 * cfg.n_layers
        add("flash_attention", 2 * n, n)
        return want
    add("rmsnorm", 1, 1)
    if cfg.block_kind == "mamba_hybrid":
        G, P = lm.zamba2_groups(cfg)
        add("ssd_scan", 2 * G * P, G * P)
        add("rmsnorm", 2 * 2 * G * P + 2 * G, 2 * G * P + 2 * G)
        add("flash_attention", G, G)
        return want
    if cfg.block_kind == "xlstm":
        G, P = lm.xlstm_groups(cfg)
        add("rmsnorm", 2 * 2 * G * P + 3 * G, 2 * G * P + 3 * G)
        return want
    L = cfg.n_layers
    norms = 2 + 2 * cfg.post_norms + 2 * cfg.qk_norm
    add("flash_attention", 2 * L, L)
    add("rmsnorm", 2 * norms * L, norms * L)
    if cfg.n_experts:
        calls = cfg.moe_scan_chunks or 1
        add("grouped_matmul", 2 * 3 * L * calls, 3 * L * calls)
    return want


class Killed(Exception):
    """Ends a training run from its ``on_step`` hook (a preemption)."""


def phase_train(smi: str) -> dict:
    """Phase 11: ``launch.train.train`` trains qwen2-0.5b at full width and
    depth (494 M parameters drawn on the card from seed 0 in bf16, AdamW
    with an fp32 master, ``SyntheticLM`` batches of 8 x 1024 tokens) for
    8 steps uninterrupted (no checkpoint); the same run, checkpointing
    every 4 steps under the git-ignored ``build/``, is killed in step 5
    (an exception from ``on_step``, after the step-4 checkpoint); a third
    run resumes from that checkpoint to step 8 (saving none).  One 7.9 GB
    checkpoint is written and read.
    Checks: every loss finite, the mean of the last two below the first,
    the killed run's losses and the resumed run's losses and final
    parameters equal to the uninterrupted run's bit for bit, and every
    step's launches what the layer count gives
    (``family_train_launches``).
    The counts are set to 0 just before the uninterrupted run and read
    just after it.
    Prints the step time p50 after two warm-up steps, tokens a second, MFU
    (``counting.model_flops`` / step time / 989 TFLOP/s), peak memory and
    one step under ``torch.profiler``.  Returns the uninterrupted run's
    launches."""
    cfg = get_config(TRAIN_ARCH)
    want = family_train_launches(cfg)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, per_step = [], []
    mark = {"t": 0.0, "n": _counts()}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, n = time.perf_counter(), _counts()
        times.append(now - mark["t"])
        per_step.append({k: n[k] - mark["n"][k] for k in n})
        mark["t"], mark["n"] = now, n

    kw = dict(batch=TRAIN_B, seq=TRAIN_S, use_reduced=False,
              ckpt_every=TRAIN_CKPT, log_every=0,
              param_dtype=torch.bfloat16, device="cuda")
    zero_train_counts()
    mark["n"] = _counts()
    t0 = time.perf_counter()
    mark["t"] = t0
    params, losses = launch_train(TRAIN_ARCH, steps=TRAIN_STEPS,
                                  on_step=on_step, **kw)
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          f"training losses {losses}")
    check(np.mean(losses[-2:]) < losses[0],
          f"the loss did not fall: {losses}")
    for i, n in enumerate(per_step):
        check(n == want, f"training step {i} launched {n}, want {want} "
              f"({cfg.n_layers} layers under remat)")
    first = []

    def kill(step, metrics):
        first.append(float(metrics["loss"]))
        if step == TRAIN_CKPT:
            raise Killed

    t1 = time.perf_counter()
    try:
        launch_train(TRAIN_ARCH, steps=TRAIN_STEPS, ckpt_dir=str(TRAIN_DIR),
                     on_step=kill, **kw)
    except Killed:
        pass
    stop_wall = time.perf_counter() - t1
    check(first == losses[:TRAIN_CKPT + 1], f"the killed run's losses "
          f"{first} against {losses[:TRAIN_CKPT + 1]}")
    check(train_ckpt.list_checkpoints(str(TRAIN_DIR)) == [TRAIN_CKPT],
          "checkpoints of the killed run")
    t1 = time.perf_counter()
    resumed, rest = launch_train(  # saving none
        TRAIN_ARCH, steps=TRAIN_STEPS, ckpt_dir=str(TRAIN_DIR),
        **dict(kw, ckpt_every=TRAIN_STEPS + 1))
    resume_wall = time.perf_counter() - t1
    check(rest == losses[TRAIN_CKPT:], f"resumed losses {rest} against "
          f"{losses[TRAIN_CKPT:]}")
    same = all(torch.equal(a, b) for a, b in
               zip(opt_leaves(resumed), opt_leaves(params)))
    check(same, "the resumed run's parameters differ from the "
          "uninterrupted run's")
    del resumed
    p50 = float(np.median(times[TRAIN_WARMUP:]))
    flops = counting.model_flops(cfg, ShapeConfig("train", "train", TRAIN_S,
                                                  TRAIN_B))
    print(f"[train] {TRAIN_ARCH} at full width and depth ({n_params:,} "
          f"parameters, bf16 with an fp32 AdamW master), B {TRAIN_B} x S "
          f"{TRAIN_S}: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; {wall:.1f} s for {TRAIN_STEPS} steps uninterrupted, the "
          f"killed run {stop_wall:.1f} s for {TRAIN_CKPT + 1} steps and a "
          f"checkpoint, the resumed run {resume_wall:.1f} s for "
          f"{TRAIN_STEPS - TRAIN_CKPT} steps after reading it; their losses "
          "and the resumed run's final parameters equal the uninterrupted "
          "run's bit for bit")
    print(f"[train] step times (ms) " + ", ".join(
        f"{1e3 * t:.1f}" for t in times) + f"; p50 after {TRAIN_WARMUP} "
        f"warm-up steps {1e3 * p50:.1f} ms, {TRAIN_B * TRAIN_S / p50:.0f} "
        f"tokens/s, MFU {flops / p50 / PEAK_OPS_PER_S[torch.bfloat16]:.2%} "
        f"({flops:.4g} model FLOPs a step at 989 TFLOP/s); peak memory "
        f"{peak:.2f} GiB ({smi})")
    print("[train] launches a step "
          + str({k: v for k, v in per_step[0].items() if v})
          + " (as family_train_launches gives); in all "
          + str({k: v for k, v in launches.items() if v}))
    # one more step under the profiler, from the trained weights
    model = build_model(cfg)
    profile_train_step(TRAIN_ARCH, model, params,
                       train_batch(cfg, TRAIN_B, TRAIN_S, TRAIN_STEPS), smi)
    del params, model
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# each training wrapper's kernels as the profiler names them, and kernels
# a counted call (bf16 at the training shapes: flash attention's tensor-core
# kernel, the grouped matmul's monolithic tile, unsplit; the flash
# backward's three tensor-core passes, its key pass unsplit at every
# trained shape: bwd_plan gives 1; the grouped-matmul backward's one
# persistent wgmma kernel, every trained shape's rows 16-byte aligned; the
# SSD-scan backward's four passes)
KERNEL_MATCH = {"flash_attention": (("flash_attention_tc", "flash_fp32"), 1),
                "flash_attention_bwd": (("flash_bwd_",), 3),
                "rmsnorm": (("rmsnorm_kernel",), 1),
                "rmsnorm_bwd": (("rmsnorm_bwd",), 2),
                "grouped_matmul": (("gmm_tiles", "gmm_small_c"), 1),
                "grouped_matmul_bwd": (("gmm_bwd_",), 1),
                "ssd_scan": (("ssd_block_states", "ssd_state_passing",
                              "ssd_block_outputs"), 3),
                "ssd_scan_bwd": (("ssd_bwd_",), 4)}


def train_batch(cfg, B: int, S: int, step: int) -> dict:
    """``launch.train``'s batch of ``step`` on the card: SyntheticLM tokens
    and labels, and for whisper the step's encoder frames."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        LMDataConfig(cfg.vocab, S, B)).batch(step).items()}
    if cfg.cross_attention:
        frames = np.random.default_rng(step).normal(
            size=(B, cfg.encoder_seq, cfg.d_model))
        batch["encoder_frames"] = torch.from_numpy(frames).float().cuda()
    return batch


def profile_train_step(tag: str, model, params, batch, smi: str):
    """One timed train step from ``params`` (a fresh AdamW state; the
    training run before it warmed every kernel), then one under
    ``torch.profiler``: wall, device busy and idle share, the top kernels,
    and each training wrapper's kernels by device time beside its count
    (calls times kernels a call) against the profiler's launches, which
    are printed side by side (by kernel where they differ)."""
    opt = model.init_opt(params)
    step = model.make_train_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {}

    def run(prof):
        before = _counts()
        with prof:
            step(params, opt, batch)
            torch.cuda.synchronize()
        counted.update({k: v - before[k] for k, v in _counts().items()})

    _, kernels = profiled(run, f"{tag} training step")
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(f"[train] {tag}: profile of one step: wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms, idle {1 - busy / wall_ms:.1%} ({smi})")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"[train]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")
    for name, (matches, per_call) in KERNEL_MATCH.items():
        if not counted.get(name):
            continue
        sel = [e for e in kernels if any(m in e.key for m in matches)]
        ms = sum(dev_us(e) for e in sel) / 1e3
        seen = sum(e.count for e in sel)
        want = counted[name] * per_call
        print(f"[train]   {name}: {ms:.3f} ms of device time "
              f"({ms / busy:.1%} of busy); counter {counted[name]} calls x "
              f"{per_call} = {want} kernels, profiler {seen} kernels"
              + ("" if seen == want else " (differ: " + "; ".join(
                  f"{e.count} x {_short(e.key)[:60]}" for e in sel) + ")"))
    del opt, step


# phase 11's new families (arch, B, S, config overrides, what is cut)
FAMILY_TRAIN = [
    ("granite-moe-1b-a400m", 8, 1024, {}, "nothing cut"),
    ("zamba2-2.7b", 4, 1024, {}, "nothing cut"),
    ("whisper-large-v3", 4, 448, {}, "nothing cut; 1500 frames a sample"),
    ("xlstm-1.3b", 4, 512, {"n_layers": 8},
     "depth cut to 1 of its 6 groups (7 mLSTM and 1 sLSTM of 48 blocks) "
     "for time: its sLSTM host loop makes a 2-group step 2.4 s")]
FAMILY_STEPS = 6


def phase_train_families(smi: str) -> dict:
    """Phase 11's new families: ``launch.train.train`` trains each of
    FAMILY_TRAIN at full width (bf16 parameters drawn on the card from
    seed 0, an fp32 AdamW master, SyntheticLM batches, whisper's frames
    drawn from the step's seed) for FAMILY_STEPS steps.  Checks: every
    loss finite and the last below the first, each step's launches what
    ``family_train_launches`` gives, one more step's gradients (from the
    trained weights, on the next batch) computed twice bit-equal, every
    leaf's gradient finite and, but for whisper's key biases (whose
    gradient is exactly zero: the softmax cancels ``q . bk``), nonzero.
    Prints the step p50 after TRAIN_WARMUP steps, tokens a second, MFU,
    peak memory, launches a step and one step under ``torch.profiler``
    (``profile_train_step``).  The counts are set to 0 just before each
    run and read just after it.  Returns each family's launches."""
    out = {}
    for arch, B, S, over, cut in FAMILY_TRAIN:
        cfg = dataclasses.replace(get_config(arch), **over)
        want = family_train_launches(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, per_step = [], []
        mark = {}

        def on_step(step, metrics):
            torch.cuda.synchronize()
            now, n = time.perf_counter(), _counts()
            times.append(now - mark["t"])
            per_step.append({k: n[k] - mark["n"][k] for k in n})
            mark["t"], mark["n"] = now, n

        zero_train_counts()
        mark["n"], mark["t"] = _counts(), time.perf_counter()
        t0 = mark["t"]
        params, losses = launch_train(
            arch, steps=FAMILY_STEPS, batch=B, seq=S, use_reduced=False,
            log_every=0, param_dtype=torch.bfloat16, device="cuda",
            overrides=over, on_step=on_step)
        wall = time.perf_counter() - t0
        out[arch] = _counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_params = sum(p.numel() for p in tree_leaves(params))
        check(all(np.isfinite(losses)) and len(losses) == FAMILY_STEPS,
              f"{arch} training losses {losses}")
        check(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
              f"{losses}")
        for i, n in enumerate(per_step):
            check(n == want, f"{arch} training step {i} launched {n}, want "
                  f"{want}")
        p50 = float(np.median(times[TRAIN_WARMUP:]))
        flops = counting.model_flops(cfg, ShapeConfig("train", "train", S,
                                                      B))
        print(f"[train] {arch} at full width ({cut}; {n_params:,} "
              f"parameters, bf16 with an fp32 AdamW master), B {B} x S {S}: "
              "losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; {wall:.1f} s for {FAMILY_STEPS} steps; step times (ms) "
              + ", ".join(f"{1e3 * t:.1f}" for t in times)
              + f"; p50 after {TRAIN_WARMUP} warm-up steps {1e3 * p50:.1f} "
              f"ms, {B * S / p50:.0f} tokens/s, MFU "
              f"{flops / p50 / PEAK_OPS_PER_S[torch.bfloat16]:.2%} "
              f"({flops:.4g} model FLOPs a step at 989 TFLOP/s); peak memory "
              f"{peak:.2f} GiB ({smi})")
        print(f"[train] {arch}: launches a step "
              + str({k: v for k, v in per_step[0].items() if v})
              + " (as family_train_launches gives)")
        model = build_model(cfg)
        batch = train_batch(cfg, B, S, FAMILY_STEPS)
        grads = []
        for _ in range(2):
            live = opt_tree_map(lambda t: t.detach().requires_grad_(), params)
            grads.append(torch.autograd.grad(model.train_loss(live, batch),
                                             opt_leaves(live)))
            del live
        check(all(map(torch.equal, *grads)), f"{arch}: one step's gradients "
              "differ between two computations")
        paths = [path for path, _ in opt_tree_paths(params)]
        for path, g in zip(paths, grads[0]):
            check(bool(torch.isfinite(g).all()), f"{arch}: gradient {path} "
                  "not finite")
            check(bool(g.any()) or (cfg.cross_attention
                                    and path.endswith("/bk")),
                  f"{arch}: gradient {path} is zero")
        print(f"[train] {arch}: one step's gradients computed twice are "
              f"bit-equal; all {len(paths)} leaves finite, every one nonzero"
              + (" but the key biases (exactly zero)" if cfg.cross_attention
                 else ""))
        del grads
        profile_train_step(arch, model, params, batch, smi)
        del params, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_parity():
    """Reduced qwen2-0.5b and gemma3-1b (windows, qk-norm, zero-centred
    norms), granite-moe-1b-a400m and qwen2-moe-a2.7b (experts, a shared
    expert), zamba2-2.7b and xlstm-1.3b (scan_chunk 16 over 64 tokens) and
    whisper-large-v3 (launch.train's frames) in fp32, weights drawn on the
    CPU and copied: the loss and
    every gradient leaf on the card (kernels) against the CPU (plain
    versions) at the first step (the same weights; later steps start from
    weights Adam has moved apart), within TRAIN_GRAD_REL of each leaf's
    largest |g| (whisper's key biases, whose gradient is exactly zero, of
    the model's largest |g|), and the parameters after 3 AdamW steps
    within the Adam-aware bound of
    ``tests/test_torch_core_qlmio.py`` (1e-6 + 2 lr steps min(1, 1e-5 s /
    |g|), s the largest gradient, |g| a value's own smallest over the
    steps).  The worst leaf is also printed against a float64 run on the
    CPU (both fp32 runs' own rounding)."""
    for arch in TRAIN_PARITY:
        over = PARITY_OVERRIDES.get(arch, {})
        cfg = reduced(get_config(arch), act_dtype="float32", **over)
        model = build_model(cfg)
        params = {"cpu": model.init(0, torch.float32, device="cpu")}
        params["cuda"] = opt_tree_map(lambda t: t.to("cuda"), params["cpu"])
        paths = [p for p, _ in opt_tree_paths(params["cpu"])]
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        steps = {d: model.make_train_step(ocfg) for d in params}
        opts = {d: model.init_opt(p) for d, p in params.items()}
        data = SyntheticLM(LMDataConfig(cfg.vocab, 64, 2))
        lo, s, worst = None, 0.0, (0.0, "", 0.0, 0.0)
        for i in range(3):
            batch = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            grads, losses = {}, {}
            runs = [(d, model, p) for d, p in params.items()]
            if cfg.cross_attention:  # launch.train's frames of step i
                batch["encoder_frames"] = torch.from_numpy(
                    np.random.default_rng(i).normal(
                        size=(2, cfg.encoder_seq, cfg.d_model))).float()
            if i == 0:  # a float64 reference of the first step
                runs.append(("float64", build_model(reduced(
                    get_config(arch), act_dtype="float64", **over)),
                    opt_tree_map(lambda t: t.double(), params["cpu"])))
            for d, m, p in runs:
                live = opt_tree_map(lambda t: t.detach().requires_grad_(), p)
                dev = "cpu" if d == "float64" else d
                loss = m.train_loss(live, {k: v.to(dev)
                                           for k, v in batch.items()})
                grads[d] = [g.cpu() for g in
                            torch.autograd.grad(loss, opt_leaves(live))]
                losses[d] = loss.item()
            check(abs(losses["cuda"] - losses["cpu"])
                  <= 1e-5 * abs(losses["cpu"]),
                  f"{arch} reduced: loss {losses['cuda']} on the card, "
                  f"{losses['cpu']} on the CPU")
            top = max(float(c.abs().max()) for c in grads["cpu"])
            for j, (g, c) in enumerate(zip(grads["cuda"], grads["cpu"])):
                err = rel_err(g, c)
                if cfg.cross_attention and paths[j].endswith("/bk"):
                    # exactly zero (the softmax cancels q . bk): both runs'
                    # rounding noise, held at the gradients' scale
                    err = float((g - c).abs().max()) / top
                if i == 0 and err > TRAIN_GRAD_REL and arch in FP32_HELD:
                    # the CPU's own fp32 gradient is no exact reference
                    # here: both fp32 runs are held to the float64 run
                    ref = grads["float64"][j]
                    cpu64, card64 = rel_err(c, ref), rel_err(g, ref)
                    check(cpu64 > TRAIN_GRAD_REL / 2 and card64 <= 2 * cpu64,
                          f"{arch} reduced: gradient {paths[j]} {err:.3g} of "
                          f"its largest |g| from the CPU's, {card64:.3g} from "
                          f"a float64 run (the CPU's {cpu64:.3g})")
                    print(f"[train parity] {arch} reduced: gradient "
                          f"{paths[j]} {err:.3g} of its largest |g| from the "
                          f"CPU's; from a float64 run the card's is {card64:.3g}"
                          f", the CPU's own fp32 run's {cpu64:.3g}")
                elif i == 0:
                    check(err <= TRAIN_GRAD_REL, f"{arch} reduced: gradient "
                          f"{paths[j]} {err:.3g} of its largest |g| from "
                          "the CPU's")
                if i == 0 and err > worst[0]:
                    ref = grads["float64"][j]
                    worst = (err, paths[j], rel_err(g, ref), rel_err(c, ref))
            ga = [g.abs() for g in grads["cpu"]]
            lo = ga if lo is None else [torch.minimum(a, b)
                                        for a, b in zip(lo, ga)]
            s = max(s, max(float(a.max()) for a in ga))
            for d in params:
                b = {k: v.to(d) for k, v in batch.items()}
                params[d], opts[d], _ = steps[d](params[d], opts[d], b)
        moved = 0.0
        for g, c, low in zip(opt_leaves(params["cuda"]),
                             opt_leaves(params["cpu"]), lo):
            diff = (g.cpu() - c).abs()
            bound = ADAM_PARAM_ATOL + 2 * ocfg.lr * 3 * torch.clamp(
                ADAM_GRAD_REL * s / low.clamp(min=1e-30), max=1.0)
            check(bool((diff <= bound).all()), f"{arch} reduced: parameters "
                  "after 3 AdamW steps outside the Adam-aware bound")
            moved = max(moved, float(diff.max()))
        print(f"[train parity] {arch} reduced, fp32: loss and gradients on "
              f"the card within {worst[0]:.2e} of each leaf's largest |g| of "
              f"the CPU's (bound {TRAIN_GRAD_REL:g}; worst {worst[1]}, "
              f"{worst[2]:.2e} from a float64 run on the card and "
              f"{worst[3]:.2e} on the CPU); parameters after 3 AdamW steps within the Adam-aware "
              f"bound (largest |diff| {moved:.3g})")


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
        with timed("compare: backward kernels"):
            worst.update(phase_train_compare())
    with timed("timing"):
        timing = phase_timing(rng, smi)
        timing.update(phase_timing_new(smi))
        with timed("timing: backward kernels"):
            timing.update(phase_train_timing(smi))
    # no serving phase may launch a backward kernel (hold_no_backward)
    zero_bwd_counts()
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
    family_launches = {}
    with timed("dense families"):
        for arch, phase in ((XLSTM_ARCH, phase_xlstm),
                            (WHISPER_ARCH, phase_whisper)):
            family_launches[arch] = phase(smi)
            gc.collect()
            torch.cuda.empty_cache()
    with timed("continuum"):
        phase_continuum(smi)
        phase_migration(smi)
    with timed("learning pipeline"):
        phase_learning(smi)
    with timed("reduced parity"):
        phase_reduced_parity()
        hybrid_parity()
        hold_no_backward()
        with timed("reduced parity: training"):
            train_parity()
    with timed("training"):
        trained = phase_train(smi)
        with timed("training: the new families"):
            families = phase_train_families(smi)
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
            "library_device_ms": t.get("library_device_ms"),
            # the launches of phase 9f's full-width runs (xlstm-1.3b,
            # whisper-large-v3), for each kernel they launch
            "launches_by_path": {arch: c[name]
                                 for arch, c in family_launches.items()
                                 if c[name]}})
        # phase 11's forward launches, by trained config
        for arch, c in [(TRAIN_ARCH, trained)] + list(families.items()):
            if c.get(name):
                kernels[-1]["launches_by_path"][f"{arch} training"] = \
                    c[name]
    # the backward kernels: phase 11's launches (the flash and RMSNorm
    # backwards: qwen2-0.5b's uninterrupted run; the grouped-matmul
    # backward: granite-moe-1b-a400m's run; the SSD-scan backward:
    # zamba2-2.7b's), and every trained config's by path
    for name, source, replaces, path in (
            ("flash_attention_bwd", "flash_attention_bwd",
             "src/repro/models/attention.py:158 (_flash_bwd, jnp; no "
             "Pallas kernel)", trained),
            ("rmsnorm_bwd", "rmsnorm",
             "src/repro/models/lm.py:79 (XLA autodiff of _norm and "
             "_head_rms :105; no Pallas kernel)", trained),
            ("grouped_matmul_bwd", "moe_gmm_bwd",
             "src/repro/models/moe.py:128 (XLA autodiff of the expert "
             "einsums :128-146; no Pallas kernel)",
             families["granite-moe-1b-a400m"]),
            ("ssd_scan_bwd", "ssd_scan_bwd",
             "src/repro/models/mamba2.py:51 (XLA autodiff of ssd_chunked; "
             "no Pallas kernel)", families["zamba2-2.7b"])):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[source],
            "replaces": replaces, "launches": path[name],
            "max_abs_err": max(worst[name], t["main_shapes_max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "launches_by_path": {
                f"{arch} training": c[name]
                for arch, c in [(TRAIN_ARCH, trained)]
                + list(families.items()) if c.get(name)}})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
