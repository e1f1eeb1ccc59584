#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device: the card's name and ``nvidia-smi`` name and power limit;
  2. build: compiles ``kernels/csrc/paged_decode.cu`` and
     ``paged_verify.cu`` for sm_90a, both nvcc runs at once (seconds,
     registers, shared memory, spills);
  3. each kernel against its plain PyTorch version on the card, bf16 and
     int8 pools, bf16 and fp32 queries: paged decode at qwen2-0.5b,
     gemma3-1b and llama3.2-3b head layouts; paged verify at the CPU
     tests' cases and at those layouts for T = 4 and T = 64;
  4. kernel, plain version and ``scaled_dot_product_attention`` times at
     the main path's shapes (decode: B 8; verify: the speculative B 8,
     T 4 and the prefill chunk B 1, T 64), beside the least time the card
     could take, and the kernel held to its plain version there;
  5. the main path: qwen2-0.5b at full width and depth (random seeded
     bf16 weights) serves 12 requests through ``ServingEngine`` with a
     bf16 and an int8 pool; decode launches must equal n_layers x decode
     steps, verify launches (chunked-prefill attention) n_layers x
     prefill chunks;
  6. speculation: the same 12 requests with ``spec_k=3``, a bf16 pool
     drafted by the target's own weights and an int8 pool drafted by a
     4-layer cut of the target; verify launches must equal n_layers x
     (verify passes + prefill chunks), the self-draft must accept half its
     drafts or more;
  7. a window of PROFILE_STEPS engine steps of the bf16 main path, run
     once plainly and once under ``torch.profiler`` with the engine's trace
     spans: device busy share, engine-span totals, top kernels by device
     time;
  8. reduced qwen2-0.5b and gemma3-1b in fp32: the engine on the CPU
     (plain versions) and on the card (kernels) give identical tokens,
     speculative engines included, and speculation on the card gives the
     tokens of plain decode;
  9. one JSON line for the kernels, then the result line.

Needs a CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository's
``src`` directory beside this file.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import paged_verify  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    paged_decode_quant_ref, paged_decode_ref, smem_bytes)
from repro_torch.kernels.paged_verify import (  # noqa: E402
    paged_verify_quant_ref, paged_verify_ref)
from repro_torch.kernels.quant import quantize_kv  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402

# H100 SXM, NVIDIA's data sheet (dense): HBM rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.int8: 1979e12}
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
# 2. Against the plain version on the same inputs in the working type (bf16
#    q), with the tolerances of test_kv_cache.py:137 (the plain version
#    rounds the probabilities to bf16 before the value product, the kernel
#    keeps them in fp32) and test_kv_quant.py:85 (int8: both dequantize to
#    the same fp32 values).  max_abs_err in the kernels line is this error.
TOL = {"paged_decode": dict(atol=5e-2, rtol=5e-2),
       "paged_decode_quant": dict(atol=5e-3, rtol=5e-3),
       "paged_verify": dict(atol=5e-2, rtol=5e-2),
       "paged_verify_quant": dict(atol=5e-3, rtol=5e-3)}
SOURCES = {"paged_decode": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "paged_verify": "src/repro_torch/kernels/csrc/paged_verify.cu"}
REPLACES = {"paged_decode": "src/repro/kernels/paged_decode.py:92",
            "paged_decode_quant": "src/repro/kernels/paged_decode.py:137",
            "paged_verify": "src/repro/kernels/paged_verify.py:95",
            "paged_verify_quant": "src/repro/kernels/paged_verify.py:147"}
WRAPPERS = {"paged_decode": ops.paged_decode,
            "paged_decode_quant": ops.paged_decode_quant,
            "paged_verify": ops.paged_verify,
            "paged_verify_quant": ops.paged_verify_quant}
PLAINS = {"paged_decode": paged_decode_ref,
          "paged_decode_quant": paged_decode_quant_ref,
          "paged_verify": paged_verify_ref,
          "paged_verify_quant": paged_verify_quant_ref}
# the pool whose main-path run each kernel serves
POOL = {"paged_decode": "bf16", "paged_decode_quant": "int8",
        "paged_verify": "bf16", "paged_verify_quant": "int8"}
SPEC_K = 3
# the model layouts the kernels are held at: (arch, H, Hkv, D, window)
WIDTHS = [("qwen2-0.5b", 14, 2, 64, 0), ("gemma3-1b", 4, 1, 256, 512),
          ("llama3.2-3b", 24, 8, 128, 0)]
# the profiled window of the main path: engine steps SKIP .. SKIP + STEPS
PROFILE_SKIP, PROFILE_STEPS = 30, 10


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


def hold(name, out, args, window, rows, where) -> tuple:
    """Holds one kernel output (rows ``rows``: slots, or a [B, T] mask) to
    its plain version both ways (see EXACT_TOL, TOL); returns the largest
    error against the fp32 plain version and in the working type (0.0 for
    an fp32 query)."""
    q = args[0]
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"{name} {where}: output {out.dtype} {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()),
          f"{name} {where}: non-finite output")
    plain = PLAINS[name]
    a = out.float()[rows]
    wide = [t.float() if t.is_floating_point() and t.dtype != torch.float32
            else t for t in args]
    exact = plain(*wide, window=window).float()[rows]
    tol = EXACT_TOL[out.dtype]
    err32 = float((a - exact).abs().max())
    check(within(a, exact, tol), f"{name} {where}: max |err| {err32} vs "
          f"the fp32 plain version, over tolerance {tol}")
    if q.dtype == torch.float32:
        return err32, 0.0
    want = plain(*args, window=window).float()[rows]
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


def phase_build():
    """Both sources at once, one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        infos = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name, info in infos.items():
        build.load(name)
        print(f"[build] {name}.cu -> sm_90a in {info['seconds']:.2f} s"
              f"{'' if info['built'] else ' (already built)'}")
        for line in info["ptxas"].splitlines():
            if "Used" in line or "spill" in line or "smem" in line:
                print("[build]   " + line.strip())
    rows = paged_verify.tile_rows()
    for arch, H, Hkv, D, _ in WIDTHS:
        G = H // Hkv
        print(f"[build]   dynamic shared memory per CTA, {arch} (G={G}, "
              f"D={D}, page 16): decode {smem_bytes(G, D, 16)} bytes; "
              f"verify {paged_verify.smem_bytes(D, 16)} bytes at T = 4 and "
              f"at T = 64 alike ({rows} query rows per CTA: "
              f"{-(-4 * G // rows) * Hkv * 8} CTAs at B 8, T 4; "
              f"{-(-64 * G // rows) * Hkv} CTAs at B 1, T 64)")


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
                    err32, err = hold(name, out, args, window, rows,
                                      f"{arch} B={B} q {qd.dtype}")
                    worst[name] = max(worst[name], err)
                    errs.append(f"{name} q {str(qd.dtype)[6:]} {err32:.3g}")
            print(f"[compare] {arch} H={H} Hkv={Hkv} D={D} window={window} "
                  f"B={B}: bf16 and int8 pool, bf16 and fp32 q agree with "
                  f"the plain version; max |err| vs fp32 plain: "
                  + ", ".join(errs))
    # verify: the CPU tests' cases (tests/test_torch_speculative.py CASES:
    # B, last context, H, Hkv, D, page, T, window), then the three model
    # layouts at the speculative T = 4 (B 8) and a 64-token chunk (B 2)
    cases = [(2, 96, 8, 2, 64, 16, 4, 0), (1, 64, 4, 4, 32, 8, 3, 24),
             (2, 72, 8, 1, 64, 8, 5, 0), (2, 128, 14, 2, 64, 16, 4, 0),
             (1, 160, 14, 2, 64, 16, 64, 0), (2, 96, 4, 1, 256, 16, 6, 40)]
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
                err32, err = hold(name, out, args, window, rows,
                                  f"B={B} T={T} H={H} D={D} q {qd.dtype}")
                check(not out.float()[~rows].any(),
                      f"{name}: rows with no key are not zero")
                worst[name] = max(worst[name], err)
                errs.append(f"{name} q {str(qd.dtype)[6:]} {err32:.3g}")
        print(f"[compare] verify B={B} T={T} H={H} Hkv={Hkv} D={D} page "
              f"{bs} window={window}, contexts up to {S}: bf16 and int8 "
              f"pool, bf16 and fp32 q agree with the plain version; max "
              f"|err| vs fp32 plain: " + ", ".join(errs))
    return worst


def _gathered(pool, bt, S):
    """[L, P, bs, Hkv, D] pool -> [L, B, Hkv, S, D] contiguous through the
    block table (the library yardstick's input; never timed)."""
    B = bt.shape[0]
    idx = bt.long().clamp(min=0)
    L, _, _, Hkv, D = pool.shape
    return torch.stack([pool[l][idx].reshape(B, S, Hkv, D)
                        .transpose(1, 2).contiguous() for l in range(L)])


def _time_kernel(name, label, q, pools, bt, pos, mask, keys, row_keys,
                 smi) -> dict:
    """Kernel, plain version and one SDPA call on the pre-gathered cache
    (int8: dequantized to bf16 first; gather and dequantization not
    timed), with ``mask`` [B, 1, rows, S] the keys each query row sees;
    one pool per layer so consecutive calls read HBM as the model does.
    ``keys`` distinct keys read per kv head and ``row_keys`` (query row,
    key) pairs per query head: the bound is the larger of the bytes
    (each K/V row once, q in, out, tables, positions) over the HBM rate
    and the q.k plus p.v multiply-adds over the peak rate."""
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

    def kernel(i=0):
        wrapper(q, *layer[i % L], bt, pos)

    def plain(i=0):
        ref(q, *layer[i % L], bt, pos)

    # [B, H, rows, D]: decode has one row, verify T
    qs = (q[:, :, None] if q.dim() == 3 else q.transpose(1, 2)).contiguous()

    def library(i=0):
        F.scaled_dot_product_attention(qs, kg[i % L], vg[i % L],
                                       attn_mask=mask, enable_gqa=True)

    err32, err = hold(name, wrapper(q, *layer[0], bt, pos),
                      (q,) + layer[0] + (bt, pos), 0, slice(None),
                      f"{label} shapes")
    bytes_s = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    ops_s = ops_count / PEAK_OPS_PER_S[pools[0].dtype]
    row = {"ms": cuda_ms(kernel, 240), "plain_ms": cuda_ms(plain, 48),
           "library_ms": cuda_ms(library, 240),
           "bound_ms": max(bytes_s, ops_s) * 1e3,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "main_shapes_max_abs_err": err}
    print(f"[timing] {name} at the {label} shapes: max |err| {err:.3g} vs "
          f"the plain version, {err32:.3g} vs the fp32 plain version")
    print(f"[timing] {name} ({label}): kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, sdpa on the gathered cache "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}; {kv_bytes + io_bytes} bytes, {ops_count} "
          f"operations), {row['bound_ms'] / row['ms']:.2%} of bound ({smi})")
    return row


def phase_timing(rng, smi: str) -> dict:
    """Times at the main path's shapes, qwen2-0.5b heads (14/2, D 64),
    page 16, 24 pools: the decode kernels at B 8 over the mixed contexts
    below (max_seq 1024 tables); the verify kernels at the speculative
    shape (B 8, T 4, the same contexts: 3820 keys) and at a prefill chunk
    (B 1, T 64, the chunk's last query at key 700).  Returns the
    kernels-line numbers: decode at its shape, verify at the speculative
    one (the chunk's are printed)."""
    L, H, Hkv, D, bs = 24, 14, 2, 64, 16
    out = {}
    for shape, B, T, NB, ctx in (
            ("decode", 8, 0, 64,
             np.asarray([60, 150, 290, 400, 520, 640, 760, 1000])),
            ("speculative", 8, SPEC_K + 1, 64,
             np.asarray([60, 150, 290, 400, 520, 640, 760, 1000])),
            ("chunk", 1, 64, 64, np.asarray([700]))):
        q, k, v, bt, pos = paged_case(rng, B, H, Hkv, D, bs, NB, ctx, T=T,
                                      layers=L)
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
        keys = int(ctx.sum())
        row_keys = int((qpos + 1).sum())
        kind = "decode" if shape == "decode" else "verify"
        for name, pools in ((f"paged_{kind}", (kb, vb)),
                            (f"paged_{kind}_quant", (k8, v8, ks, vs))):
            label = f"{shape} (B={B}{f', T={T}' if T else ''}, contexts " \
                    f"{ctx.tolist()})"
            row = _time_kernel(name, label, q, pools, bt, pos, mask, keys,
                               row_keys, smi)
            if shape != "chunk":
                out[name] = row
        del kb, vb, k8, v8
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


def _warm_engine(model, params, kv_dtype, telemetry=None, **kw):
    """An engine for the main path whose first cuBLAS calls and caches are
    already warm (one short request, then metrics and prefix cache reset),
    and the 12 requests it is to serve; ``kw`` reaches the engine (the
    speculation knobs)."""
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
    reqs = [Request(i, p, max_new_tokens=32)
            for i, p in enumerate(_prompts(np.random.default_rng(1), vocab))]
    return eng, reqs


def _drive(eng, reqs) -> "tuple[float, dict, dict]":
    """Serve ``reqs`` with every launch count set to 0 just before; returns
    the wall time, the counts read just after, and the engine's stats.
    Every request must get its full budget of in-vocabulary tokens."""
    torch.cuda.reset_peak_memory_stats()
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
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
            f"p50 {lat['itl_p50_s'] * 1e3:.2f} ms; decode "
            f"{st['decode_tokens'] / wall:.1f} tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main_model():
    """qwen2-0.5b at full width and depth, random bf16 weights, on the
    card."""
    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"[main] qwen2-0.5b full width: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, bf16 weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


def phase_main_path(model, params, smi: str):
    """Returns the launch count of each kernel in its pool's run and the
    streams each pool's run gave (phase 6 compares speculation to them).
    Decode launches n_layers per decode step, verify (the chunked-prefill
    attention) n_layers per prefill chunk; the other pool's kernels
    never."""
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
        check(counts == want, f"{kv_dtype} pool launched {counts}, want "
              f"{want} ({steps} decode steps, {chunks} prefill chunks)")
        launches.update({n: c for n, c in counts.items()
                         if POOL[n] == kv_dtype})
        streams[kv_dtype] = [tuple(r.output) for r in reqs]
        print(f"[main] {kv_dtype} pool: 12 requests, prompts "
              f"{sum(len(r.tokens) for r in reqs)} tokens "
              f"({st['prefix_tokens_reused']} reused, {st['prefix_hits']} "
              f"prefix hits) in {chunks} prefill chunks, "
              f"{st['decode_tokens']} decode tokens in {steps} decode "
              f"steps, {wall:.3f} s wall; {_latency_line(st, wall)}; "
              f"launches: paged_decode{q} {want[f'paged_decode{q}']} = "
              f"{L} x {steps}, paged_verify{q} {want[f'paged_verify{q}']} "
              f"= {L} x {chunks} ({smi})")
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
    4-layer cut of it.  Returns each verify kernel's launches in its
    pool's run."""
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
        q = "_quant" if kv_dtype == "int8" else ""
        want = {n: 0 for n in WRAPPERS}
        want[f"paged_verify{q}"] = L * (ticks + chunks)
        check(counts == want, f"speculative {kv_dtype} pool launched "
              f"{counts}, want {want} ({ticks} verify passes, {chunks} "
              "prefill chunks)")
        launches[f"paged_verify{q}"] = counts[f"paged_verify{q}"]
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
              f"{len(reqs)}; paged_verify{q} launches "
              f"{counts[f'paged_verify{q}']} = {L} x ({ticks} + {chunks}) "
              f"({smi})")
    return launches


def phase_profile(model, params, smi: str):
    """Where the main path's time goes, over a short window: engine steps
    PROFILE_SKIP .. PROFILE_SKIP + PROFILE_STEPS of the bf16 workload
    (prefill chunks and decode ticks), run once plainly for the wall time
    and once more, the same steps, with the engine's trace spans and
    torch.profiler on.  The idle share is the profiled kernels' device time
    against the plain run's wall time."""

    def window(telemetry, profiler):
        eng, reqs = _warm_engine(model, params, "bf16", telemetry)
        for r in reqs:
            eng.submit(r)
        for _ in range(PROFILE_SKIP):
            eng.step()
        torch.cuda.synchronize()
        if telemetry is not None:
            telemetry.tracer.clear()
        with profiler:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return wall

    wall = window(None, contextlib.nullcontext())
    tel = Telemetry(trace=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    pwall = window(tel, prof)
    spans: dict = {}
    for ev in tel.tracer.events:
        if ev.get("ph") == "X" and ev["cat"] in ("engine", "prefill"):
            n, t = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, t + ev["dur"] / 1e6)
    check(spans.get("decode_tick", (0,))[0] > 0,
          f"the profiled window ran no decode tick: {spans}")

    def dev_us(e):  # the attribute's name differs across torch versions
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0

    # device kernels only: a CPU op's self device time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    print(f"[profile] bf16 main path, engine steps {PROFILE_SKIP}.."
          f"{PROFILE_SKIP + PROFILE_STEPS}: wall {wall:.4f} s (under "
          f"torch.profiler {pwall:.4f} s); device busy {busy:.4f} s = "
          f"{busy / wall:.1%} of the plain wall, idle {1 - busy / wall:.1%}"
          f" ({smi})")
    print("[profile] engine spans (host wall clock, profiled run): " +
          "; ".join(f"{name} {n} x, {t:.4f} s"
                    for name, (n, t) in sorted(spans.items())))
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x "
              f"{e.key[:90]}")


def phase_reduced_parity():
    """fp32 at reduced size, where greedy tokens are sound to compare: the
    CPU engine (plain versions) and the CUDA engine (kernels) agree, plain
    and speculative (self-draft, spec_k=3), and speculation on the card
    gives the tokens of plain decode."""
    for arch in ("qwen2-0.5b", "gemma3-1b"):
        cfg = reduced(get_config(arch), act_dtype="float32")
        model = build_model(cfg)
        cpu_params = model.init(0, param_dtype=torch.float32, device="cpu")
        gpu_params = _tree_map(lambda t: t.to("cuda"), cpu_params)
        rng = np.random.default_rng(2)
        shared = rng.integers(0, cfg.vocab, 24)
        prompts = [rng.integers(0, cfg.vocab, n) for n in (6, 21, 33, 9, 50)]
        prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab, 5)])
                    for _ in range(3)]
        for kv_dtype in ("bf16", "int8"):
            outs = {}
            for (dev, params), spec in itertools.product(
                    (("cpu", cpu_params), ("cuda", gpu_params)),
                    (False, True)):
                kw = dict(draft_config=cfg, draft_params=params,
                          spec_k=SPEC_K) if spec else {}
                eng = ServingEngine(model, params, max_batch=3, max_seq=128,
                                    page_size=8, kv_dtype=kv_dtype,
                                    prefill_chunk=16, device=dev, **kw)
                reqs = [Request(i, p, max_new_tokens=8)
                        for i, p in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                eng.run_until_drained()
                outs[dev, spec] = [tuple(r.output) for r in reqs]
            for a, b, what in (
                    (("cpu", False), ("cuda", False), "CPU and CUDA engines"),
                    (("cpu", True), ("cuda", True),
                     "CPU and CUDA speculative engines"),
                    (("cuda", False), ("cuda", True),
                     "CUDA plain and speculative engines")):
                check(outs[a] == outs[b], f"{arch} {kv_dtype}: {what} "
                      f"disagree:\n{outs[a]}\n{outs[b]}")
            print(f"[parity] reduced {arch} fp32, {kv_dtype} pool: CPU "
                  f"(plain) and CUDA (kernels) engines give identical tokens "
                  f"for {len(prompts)} requests, plain and speculative "
                  f"(spec_k={SPEC_K}); on the card speculation gives the "
                  f"tokens of plain decode")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main():
    t_start = time.perf_counter()
    # fp32 products in fp32 (no TF32), for the fp32 comparisons and parity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    worst = phase_compare(rng)
    timing = phase_timing(rng, smi)
    model, params = main_model()
    launches, streams = phase_main_path(model, params, smi)
    spec_launches = phase_speculation(model, params, streams, smi)
    phase_profile(model, params, smi)
    del params
    phase_reduced_parity()
    kernels = []
    for name in WRAPPERS:
        t = timing[name]
        # decode kernels: the main path's launches; verify kernels: the
        # speculative path's (verify passes and prefill chunks)
        n = spec_launches.get(name, launches[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name.removesuffix("_quant")],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": max(worst[name], t["main_shapes_max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
