"""End-to-end serving example on the PyTorch port: three real model
engines (reduced configs of assigned architectures) as a cloud-edge
continuum behind the QLMIO router, with continuous batching, health
tracking, hedged requests, and a mid-run server failure that the router
drains around (after ``examples/serve_cluster.py``).  Runs on the CUDA
card unless ``--device cpu`` is given.

Run:  python examples/pt_serve_cluster.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.launch.serve import build_cluster  # noqa: E402
from repro_torch.serving.router import QLMIORouter  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--healthy", type=int, default=8,
                help="tasks before edge-1 dies")
ap.add_argument("--after", type=int, default=12,
                help="tasks after edge-1 dies")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

servers = build_cluster(device=args.device)
speeds = np.array([s.speed for s in servers])
milp = lambda task, s: 8.0 / speeds[s]  # noqa: E731
mgqp = lambda task, s: [0.7, 0.85, 0.95][s]  # noqa: E731
router = QLMIORouter(list(servers), milp, mgqp, quality_weight=0.3)

print("phase 1: healthy cluster")
for task in range(args.healthy):
    rec = router.dispatch(task)
    print(f"  task {task} -> {servers[rec['server']].name} "
          f"lat={rec['latency']:.2f} ok={rec['ok']}")

print("phase 2: edge-1 dies mid-run")
servers[1].fail = True
for task in range(args.healthy, args.healthy + args.after):
    rec = router.dispatch(task)
    mark = " <- failed box" if rec["server"] == 1 else ""
    print(f"  task {task} -> {servers[rec['server']].name} "
          f"ok={rec['ok']}{mark}")
counts = np.bincount([r["server"] for r in router.log],
                     minlength=len(servers))
fails_after = sum(1 for r in router.log[args.healthy:] if r["server"] == 1)
print(f"dispatch counts: {counts.tolist()}; "
      f"post-failure hits on dead box: {fails_after} "
      f"(<= health threshold {router.health.fail_threshold})")
if fails_after > router.health.fail_threshold:
    raise AssertionError("traffic was not drained from the failed server")
print("fault tolerance OK: traffic drained from the failed server")
