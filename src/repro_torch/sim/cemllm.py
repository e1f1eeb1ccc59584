"""CEMLLM-Sim: trace-driven cloud-edge collaborative MLLM system simulator
(paper Sec. V-B).

Replays MIOBench: any offloading decision's ground-truth latency/quality is a
table lookup, so policies train/evaluate without real hardware.  Supports the
paper's 5/10/15-server configurations (Table III), per-server queues (Eq. 3),
timeouts, episodes, and health/failure injection (serving-layer fault
tolerance hooks).

The *execution backend* of an episode is pluggable:

  * ``CostModelBackend`` (default) — the closed-form table lookup above;
    every record resolves at dispatch time.  This is what policy training
    uses (immediate rewards).
  * ``EngineBackend`` (repro_torch/serving/cluster.py) — each decision
    submits a real request to a live ``ServingEngine`` behind the chosen
    server and
    the continuum harness advances all engines under a shared virtual
    clock.  Records are *pending* until ``Episode.finalize()`` drains the
    cluster, which patches in measured TTFT / e2e latency; the provisional
    latency/success at dispatch time is the same cost-model estimate the
    default backend returns, so a deterministic policy takes identical
    decisions under either backend (backend parity).

Both backends expose ``execute(task, server) -> (latency_r, ok, resolved)``
and ``drain() -> None``.

A copy of ``repro/sim/cemllm.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.cost_model import TIMEOUT_S
from repro_torch.sim.miobench import MIOBench, SERVER_CLASSES


# paper Table III: (class_index, count) per configuration; class 2 = cloud
SYSTEM_CONFIGS = {
    5: [(2, 1), (1, 1), (0, 3)],
    10: [(2, 1), (1, 2), (0, 7)],
    15: [(2, 1), (1, 4), (0, 10)],
}


@dataclasses.dataclass
class Servers:
    """Static server table for one configuration."""
    cls: np.ndarray  # [E+1] server-class index into SERVER_CLASSES
    model_id: np.ndarray  # [E+1]
    device_id: np.ndarray  # [E+1]
    is_cloud: np.ndarray  # [E+1] bool

    @property
    def n(self) -> int:
        return len(self.cls)


def make_servers_from_spec(spec, bench: MIOBench) -> Servers:
    """Server table from an explicit ``[(class_idx, count), ...]`` spec —
    the same layout the continuum harness's ``build_continuum`` uses, so a
    sim ``Servers`` table and a list of live ``EngineHandle``s built from
    one spec index the same fleet."""
    cls = []
    for class_idx, count in spec:
        cls += [class_idx] * count
    cls = np.array(cls)
    return Servers(cls=cls,
                   model_id=bench.model_id[cls],
                   device_id=bench.device_id[cls],
                   is_cloud=(cls == len(SERVER_CLASSES) - 1))


def make_servers(n_servers: int, bench: MIOBench) -> Servers:
    return make_servers_from_spec(SYSTEM_CONFIGS[n_servers], bench)


class CostModelBackend:
    """Closed-form execution: ground-truth latency/quality table lookup.

    Every decision resolves immediately; ``drain`` is a no-op."""

    def __init__(self, bench: MIOBench, servers: Servers,
                 failed: np.ndarray):
        self.bench = bench
        self.servers = servers
        self.failed = failed

    def execute(self, task: int, server: int):
        """(response_latency_s, success_bool, resolved=True)."""
        c = int(self.servers.cls[server])
        lat = float(self.bench.latency_s[task, c])
        sc = int(self.bench.score[task, c])
        if self.failed[server]:
            return TIMEOUT_S * 4, False, True
        return lat, sc == 1, True

    def drain(self):
        pass


class Episode:
    """One decision episode: U users each propose a task; a policy assigns
    each task to a server; queues accumulate (Eqs. 2-3).

    ``backend`` (default ``CostModelBackend``) performs the actual
    execution; pass ``repro_torch.serving.cluster.EngineBackend`` to replay the
    episode against live ``ServingEngine`` instances.  With a pending
    backend, call ``finalize()`` after the last ``step`` so measured
    latencies replace the dispatch-time estimates in the returned records
    (the record dicts are patched in place)."""

    def __init__(self, bench: MIOBench, servers: Servers, task_ids,
                 rng: np.random.Generator, failed: np.ndarray | None = None,
                 backend=None):
        self.bench = bench
        self.servers = servers
        self.task_ids = np.asarray(task_ids)
        self.rng = rng
        self.queue_s = np.zeros(servers.n)  # actual queued latency (Eq. 3)
        self.queue_len = np.zeros(servers.n, np.int64)
        self.t = 0
        # failure injection: a failed server never completes tasks and its
        # queue grows unboundedly (fault-tolerance experiments)
        self.failed = (np.zeros(servers.n, bool) if failed is None else failed)
        self._cost = CostModelBackend(bench, servers, self.failed)
        self.backend = self._cost if backend is None else backend

    @property
    def done(self) -> bool:
        return self.t >= len(self.task_ids)

    @property
    def current_task(self) -> int:
        return int(self.task_ids[self.t])

    def ground_truth(self, task: int, server: int):
        """(response_latency_s, success_bool) for this offloading decision
        under the closed-form cost model (backend-independent estimate)."""
        lat, ok, _ = self._cost.execute(task, server)
        return lat, ok

    def step(self, server: int):
        """Offload the current task; returns a record dict.  When the
        backend is asynchronous the latency/success fields hold the
        cost-model estimate until ``finalize()`` patches them."""
        task = self.current_task
        lat_r, ok, resolved = self.backend.execute(task, server)
        total = lat_r + self.queue_s[server]  # Eq. 2
        timeout = total > TIMEOUT_S
        success = ok and not timeout
        self.queue_s[server] += lat_r
        self.queue_len[server] += 1
        self.t += 1
        rec = {"task": task, "server": server, "latency_r": lat_r,
               "latency_total": total, "success": success,
               "timeout": timeout, "pending": not resolved}
        if not resolved:
            self.backend.register(rec)
        return rec

    def finalize(self):
        """Resolve pending records (no-op for the cost-model backend)."""
        self.backend.drain()


def greedy_latencies(bench: MIOBench, servers: Servers, task_ids):
    """The paper's Greedy comparator (Eq. 21): offload each task to the
    server with the shortest queue; returns per-task total latency."""
    q = np.zeros(servers.n)
    out = np.zeros(len(task_ids))
    for i, t in enumerate(task_ids):
        s = int(np.argmin(q))
        lat = bench.latency_s[int(t), servers.cls[s]]
        out[i] = lat + q[s]
        q[s] += lat
    return out


def run_policy(policy, bench: MIOBench, servers: Servers, task_ids,
               rng: np.random.Generator, failed=None, backend=None) -> dict:
    """Roll a full episode with ``policy(episode) -> server``; aggregate the
    paper's metrics.  With an asynchronous ``backend`` (EngineBackend) the
    records are aggregated only after ``finalize()`` fills in the measured
    latencies, and the mean TTFT over finished requests is reported too."""
    ep = Episode(bench, servers, task_ids, rng, failed=failed,
                 backend=backend)
    recs = []
    while not ep.done:
        recs.append(ep.step(policy(ep)))
    ep.finalize()
    lat = [r["latency_total"] for r in recs]
    succ = [r["success"] for r in recs]
    out = {"avg_latency_s": float(np.mean(lat)),
           "completion_rate": float(np.mean(succ)),
           "p95_latency_s": float(np.percentile(lat, 95))}
    ttft = [r["ttft_s"] for r in recs if "ttft_s" in r]
    if ttft:
        out["avg_ttft_s"] = float(np.mean(ttft))
    return out
