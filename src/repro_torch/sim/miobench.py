"""MIOBench: MLLM Inference Offloading Benchmark (paper Sec. V-A).

3,377 tasks x 3 server classes = 10,131 offloading records with the fields of
Table II.  Records are synthesized from the quarantined cost model
(repro_torch/sim/cost_model.py) — see the "Design notes" section of the
top-level README.md for the fidelity discussion.

A copy of ``repro/sim/miobench.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.data.taskgen import CATEGORIES, TaskSet, make_taskset
from repro_torch.sim import cost_model as cm

SERVER_CLASSES = [  # (device, model) — paper Table I
    ("jetson_orin_nano", "qwen3vl-2b"),
    ("rtx3090ti", "qwen3vl-8b"),
    ("rtx5090", "qwen3vl-30b"),
]


@dataclasses.dataclass
class MIOBench:
    tasks: TaskSet
    # [n_tasks, n_classes]
    latency_s: np.ndarray
    score: np.ndarray  # 1 success, 0 incorrect, -1 timeout
    model_id: np.ndarray  # [n_classes] index into cm.MODEL_IDS
    device_id: np.ndarray

    @property
    def n_records(self) -> int:
        return self.tasks.n * len(SERVER_CLASSES)

    def records(self):
        """Iterate Table-II-style dicts."""
        for t in range(self.tasks.n):
            for c, (dev, mdl) in enumerate(SERVER_CLASSES):
                yield {
                    "dataset": "MMBench-synthetic",
                    "prompt": f"task-{t}",
                    "device_type": dev,
                    "model_name": mdl,
                    "score": int(self.score[t, c]),
                    "latency_ms": float(self.latency_s[t, c] * 1e3),
                    "sample_id": t,
                    "index": t * len(SERVER_CLASSES) + c,
                    "source": CATEGORIES[int(self.tasks.category[t])],
                }


def generate(seed: int = 0, n_tasks: int | None = None,
             prefill_chunk: int | None = None) -> MIOBench:
    """``prefill_chunk`` (None = legacy smooth latency model) synthesizes
    latencies with the serving engine's bucketed/chunked prefill term, so
    predictors trained on the bench match the real engine's step-function
    prefill cost (see cost_model.chunked_prefill_tokens)."""
    tasks = make_taskset(n_tasks or 3377, seed)
    rng = np.random.default_rng(seed + 1)
    aff = cm.category_affinity(len(CATEGORIES), len(SERVER_CLASSES))
    n = tasks.n
    lat = np.zeros((n, len(SERVER_CLASSES)))
    score = np.zeros((n, len(SERVER_CLASSES)), np.int64)
    model_id = np.array([cm.MODEL_IDS.index(m) for _, m in SERVER_CLASSES])
    device_id = np.array([cm.DEVICE_IDS.index(d) for d, _ in SERVER_CLASSES])
    for c, (dev, mdl) in enumerate(SERVER_CLASSES):
        device, model = cm.DEVICES[dev], cm.MODELS[mdl]
        lat[:, c] = cm.latency_s(device, model, tasks.text_len,
                                 tasks.difficulty, rng,
                                 prefill_chunk=prefill_chunk)
        p = cm.success_prob(model, tasks.difficulty,
                            aff[tasks.category, c])
        ok = rng.random(n) < p
        timeout = lat[:, c] > cm.TIMEOUT_S
        score[:, c] = np.where(timeout, -1, ok.astype(np.int64))
    return MIOBench(tasks, lat, score, model_id, device_id)


def save_jsonl(bench: MIOBench, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for rec in bench.records():
            f.write(json.dumps(rec) + "\n")


def summary(bench: MIOBench) -> dict:
    out = {"n_tasks": bench.tasks.n, "n_records": bench.n_records}
    for c, (dev, mdl) in enumerate(SERVER_CLASSES):
        s = bench.score[:, c]
        out[f"{dev}"] = {
            "model": mdl,
            "accuracy": float((s == 1).mean()),
            "timeout_rate": float((s == -1).mean()),
            "latency_p50_s": float(np.median(bench.latency_s[:, c])),
            "latency_p95_s": float(np.percentile(bench.latency_s[:, c], 95)),
        }
    return out
