"""Cloud-edge continuum replay on the PyTorch port: QLMIO offloading over
live ``ServingEngine``s (after ``examples/serve_continuum.py``), on the
CUDA card unless ``--device cpu`` is given.

Three live engines (paged KV + chunked prefill, reduced configs) form a
continuum: a jetson-class and a 3090-class edge running the small config,
a 5090-class cloud running the larger one, under a shared virtual clock.
A MIOBench arrival trace is replayed twice: all-cloud vs. the QLMIO
scoring policy.  Latency is measured from real token generation (virtual
seconds); quality comes from the success predictors.

Run:  python examples/pt_serve_continuum.py [--device cpu] [--users N]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core.baselines import all_cloud_policy  # noqa: E402
from repro_torch.serving.cluster import (Cluster,  # noqa: E402
                                         EngineBackend, build_continuum)
from repro_torch.serving.request import ContinuumRequest  # noqa: E402
from repro_torch.sim.cemllm import (make_servers_from_spec,  # noqa: E402
                                    run_policy)
from repro_torch.sim.miobench import generate  # noqa: E402
from repro_torch.sim.policies import (analytic_predictors,  # noqa: E402
                                      qlmio_policy)

SPEC = [(2, 1), (1, 1), (0, 1)]  # 1 cloud + 2 edge tiers

ap = argparse.ArgumentParser()
ap.add_argument("--users", type=int, default=24,
                help="tasks of the replayed trace")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

bench = generate(seed=0, n_tasks=200)
servers = make_servers_from_spec(SPEC, bench)
handles = build_continuum(SPEC, seed=0, torch_device=args.device)
cluster = Cluster(handles)
rng = np.random.default_rng(0)
tasks = rng.choice(bench.tasks.n, args.users, replace=False)

# QLMIO scoring policy over the idealized cost-model predictors
t_hat, b_hat = analytic_predictors(bench)

for name, policy in [("all_cloud", all_cloud_policy(servers)),
                     ("qlmio", qlmio_policy(t_hat, b_hat, servers, w=1.0))]:
    cluster.reset()
    backend = EngineBackend(cluster, bench, servers, arrival_dt=0.01)
    out = run_policy(policy, bench, servers, tasks,
                     np.random.default_rng(1), backend=backend)
    print(f"[{name}] mean e2e {out['avg_latency_s']:.3f}s  "
          f"ttft {out.get('avg_ttft_s', 0.0):.3f}s  "
          f"completion {out['completion_rate']:.2f}")
    for h in handles:
        st = h.engine.latency_stats()
        if st["n_requests"]:
            print(f"    {h.name}: {st['n_requests']} reqs, "
                  f"e2e p95 {st['e2e_p95_s']:.3f}s (virtual clock), "
                  f"ticks {h.engine.ticks}")

# the router's live-load probe: each handle reports its real congestion
print("live load probes (post-drain, all idle):")
for h in handles:
    print(f"    {h.name}: {h.load()}")

# the streaming front end: per-token delivery on the same virtual clock;
# tokens surface as they decode, TTFT is measured at the first streamed
# chunk instead of the drained response payload
cluster.reset()
prompt = rng.integers(1, handles[0].cfg.vocab, 16).astype(np.int32)
uid = cluster.submit(ContinuumRequest(tokens=prompt, max_new_tokens=6,
                                      task=0, server=1, stream=True))
print("streamed tokens:")
for ev in cluster.stream(until=30.0):
    print(f"    #{ev.index} tok={ev.token} t_user={ev.t_user:.4f}s"
          + ("  (first)" if ev.first else "")
          + ("  (final)" if ev.final else ""))
rec = [r for r in cluster.collect() if r["uid"] == uid][0]
print(f"    streamed ttft {rec['ttft_s']:.4f}s  e2e {rec['e2e_s']:.4f}s")
