"""Quickstart on the PyTorch port: the full QLMIO pipeline (after
``examples/quickstart.py``), on the CUDA card unless ``--device cpu`` is
given.

1. Synthesize MIOBench (3,377 tasks x 3 server classes; 600 here).
2. Compute frozen encoder features, train the MGQP + MILP predictor heads.
3. Train the QLMIO D3QN offloading agent on CEMLLM-Sim.
4. Compare against the All-Cloud / Greedy / Random baselines on the test
   split.

Run:  python examples/pt_quickstart.py [--device cpu] [--tasks N]
      [--episodes N] [--epochs N] [--trials N]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.core.d3qn import D3QNConfig  # noqa: E402
from repro_torch.core.feature_store import compute_features  # noqa: E402
from repro_torch.core.predictors import (Predictor,  # noqa: E402
                                         PredictorConfig)
from repro_torch.core.qlmio import QLMIO, QLMIOConfig  # noqa: E402
from repro_torch.data.taskgen import splits  # noqa: E402
from repro_torch.sim.cemllm import make_servers  # noqa: E402
from repro_torch.sim.miobench import (SERVER_CLASSES, generate,  # noqa: E402
                                      summary)

ap = argparse.ArgumentParser()
ap.add_argument("--tasks", type=int, default=600, help="full bench: 3377")
ap.add_argument("--profile", default="tiny",
                help='encoder profile (paper fidelity: "fast" or "paper")')
ap.add_argument("--episodes", type=int, default=120, help="paper: 12000")
ap.add_argument("--epochs", type=int, default=10,
                help="predictor training epochs")
ap.add_argument("--users", type=int, default=15)
ap.add_argument("--servers", type=int, default=5)
ap.add_argument("--trials", type=int, default=10,
                help="evaluation trials of each policy")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = args.device

t0 = time.time()
bench = generate(seed=0, n_tasks=args.tasks)
print("MIOBench:", {k: v for k, v in summary(bench).items()
                    if k in ("n_tasks", "n_records")})
tr, va, te = splits(bench.tasks.n)
f_img, f_text = compute_features(bench.tasks, profile=args.profile,
                                 cache_dir=None, device=dev)


def flat(ids):
    C = len(SERVER_CLASSES)
    t = np.repeat(ids, C)
    c = np.tile(np.arange(C), len(ids))
    return {"f_text": f_text[t], "f_img": f_img[t],
            "model_id": bench.model_id[c], "device_id": bench.device_id[c],
            "label": (bench.score[t, c] == 1).astype(np.int64),
            "latency_s": bench.latency_s[t, c].astype(np.float32)}


pc = PredictorConfig(epochs=args.epochs, batch=256)
milp = Predictor("latency", 8, 8, pc, feat_dim=f_text.shape[1], device=dev)
h = milp.fit(flat(tr), flat(va))
print(f"[{time.time()-t0:.0f}s] MILP  val MAE  {h[-1]['val_mae_s']:.2f}s")
mgqp = Predictor("quality", 8, 8, pc, feat_dim=f_text.shape[1], device=dev)
h = mgqp.fit(flat(tr), flat(va))
print(f"[{time.time()-t0:.0f}s] MGQP  val acc  {h[-1]['val_acc']:.3f}")

C = len(SERVER_CLASSES)
allb = {"f_text": np.repeat(f_text, C, 0), "f_img": np.repeat(f_img, C, 0),
        "model_id": np.tile(bench.model_id, bench.tasks.n),
        "device_id": np.tile(bench.device_id, bench.tasks.n)}
milp_preds = milp.predict(allb).reshape(-1, C)
mgqp_preds = mgqp.predict(allb).reshape(-1, C)

servers = make_servers(args.servers, bench)
q = QLMIO(bench, servers, (f_img, f_text), milp_preds, mgqp_preds,
          QLMIOConfig(episodes=args.episodes, users=args.users, seed=0,
                      agent=D3QNConfig(
                          eps_decay_steps=args.episodes * args.users // 2)),
          device=dev)
q.train(tr, verbose=True, log_every=40)
res = q.evaluate(te, trials=args.trials)
print(f"[{time.time()-t0:.0f}s] QLMIO  : {res}")
for name, r in B.evaluate_heuristics(bench, servers, te, args.users,
                                     args.trials).items():
    print(f"         {name:10s}: {r}")
