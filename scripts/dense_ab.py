"""What routing the column-cut projections through the hand-written dense
product costs end to end on the card, against cuBLAS (``x @ w``, which the
port called for them before the kernel), in one process on one card.

    PYTHONPATH=src python scripts/dense_ab.py

Two arms, the only difference between them the projections' product:
"cuBLAS" patches ``lm.dense_matmul`` and ``ops.dense_matmul`` (the MoE
shared expert's) to ``x @ w``; "kernel" is the port as it stands.  The arms
run in turn (ORDER: cuBLAS, kernel, kernel, cuBLAS, cuBLAS, kernel) on

* the text path of ``chip_smoke.py`` phase 5: qwen2-0.5b at full width,
  12 of its 24 layers, seeded bf16 weights drawn on the card, its 12
  requests (32 new tokens each) through a warm paged bf16 engine: wall
  seconds, TTFT and ITL p50 and p95, decode tokens a second;
* a training step of phase 11: qwen2-0.5b at full width and depth (B 8 x
  S 1024, bf16 with an fp32 AdamW master, ``SyntheticLM`` batches), the
  p50 of 6 steps after 2 warm-up steps.

Prints the card's name and power limit, one line per reading and each
arm's median.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402

SOURCES = ("paged_decode", "paged_verify", "rmsnorm", "flash_attention",
           "flash_attention_bwd", "dense_matmul")
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
ORDER = ("cuBLAS", "kernel", "kernel", "cuBLAS", "cuBLAS", "kernel")


def cublas(x, w, *, plan_n=None):
    return x @ w


@contextlib.contextmanager
def arm(name: str):
    """The projections through cuBLAS ("cuBLAS") or the kernel
    ("kernel")."""
    if name == "kernel":
        yield
        return
    saved = lm.dense_matmul, ops.dense_matmul
    lm.dense_matmul = ops.dense_matmul = cublas
    try:
        yield
    finally:
        lm.dense_matmul, ops.dense_matmul = saved


def text_path(model, params, name: str, smi: str):
    with arm(name):
        eng, reqs = cs._warm_engine(model, params, "bf16")
        wall, counts, st = cs._drive(eng, reqs)
    lat = st["latency"]
    print(f"[ab] text path, {name}: {wall:.3f} s wall, TTFT p50 "
          f"{lat['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{lat['ttft_p95_s'] * 1e3:.1f} ms, ITL p50 "
          f"{lat['itl_p50_s'] * 1e3:.2f} ms p95 "
          f"{lat['itl_p95_s'] * 1e3:.2f} ms, decode "
          f"{st['decode_tokens'] / wall:.1f} tokens/s; dense_matmul "
          f"launches {counts['dense_matmul']} ({smi})")
    return [tuple(r.output) for r in reqs], lat["itl_p50_s"] * 1e3


def train_steps(model, params, name: str, smi: str):
    cfg = model.cfg
    opt = model.init_opt(params)
    step = model.make_train_step()
    times = []
    with arm(name):
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            batch = cs.train_batch(cfg, cs.TRAIN_B, cs.TRAIN_S, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    del opt, step
    p50 = statistics.median(times[TRAIN_WARMUP:])
    print(f"[ab] {cfg.name} training step (B {cs.TRAIN_B} x S "
          f"{cs.TRAIN_S}), {name}: p50 {p50:.1f} ms of "
          + ", ".join(f"{t:.1f}" for t in times[TRAIN_WARMUP:])
          + f" ({smi})")
    return p50


def medians(label: str, readings: list):
    """Each arm's median of ``readings`` [(arm, value)]."""
    by_arm = {name: [v for a, v in readings if a == name]
              for name in ("cuBLAS", "kernel")}
    print(f"[ab] {label}: " + "; ".join(
        f"{name} median {statistics.median(v):.2f} of "
        f"{[round(x, 2) for x in v]}" for name, v in by_arm.items()))


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))
    torch.manual_seed(0)
    model, params = cs.main_model()
    streams, itl = {}, []
    for name in ORDER:
        streams[name], ms = text_path(model, params, name, smi)
        itl.append((name, ms))
    medians("text path ITL p50 (ms)", itl)
    same = sum(a == b for a, b in zip(streams["cuBLAS"], streams["kernel"]))
    print(f"[ab] text path: the kernel arm's streams equal the cuBLAS arm's "
          f"for {same} of {len(streams['kernel'])} requests (bf16 sums in "
          "another order may flip a near-tie)")
    del model, params
    torch.cuda.empty_cache()
    model = cs.build_model(cs.get_config(cs.TRAIN_ARCH))
    params = model.init(0, param_dtype=torch.bfloat16, device="cuda")
    medians(f"{cs.TRAIN_ARCH} training step p50 (ms)",
            [(name, train_steps(model, params, name, smi)) for name in ORDER])


if __name__ == "__main__":
    main()
