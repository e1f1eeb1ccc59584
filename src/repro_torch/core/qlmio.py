"""QLMIO: Quality-Latency Tradeoff-Aware MLLM Inference Offloading
(paper Sec. IV-B, Algorithm 1).

Port of ``repro/core/qlmio.py``: the JAX module with the port's agent,
which runs on ``device`` (the card unless the caller says ``"cpu"``).
All of the harness's randomness is numpy, so from the same agent weights
its decisions are the JAX package's until the first parameter update.

One class covers the full framework and its ablations/baselines:
  * QLMIO            — MILP + MGQP predictions + multimodal task features
  * QLMIO w/o MILP   — use_milp=False   (t_hat branch zeroed)
  * QLMIO w/o MGQP   — use_mgqp=False   (b_hat branch zeroed)
  * QLMIO w/o both   — both off
  * D3QN baseline    — use_task_features=False, both predictors off
  * QoS-Aware RL     — text-only features + linear-regression latency
                       estimates (pass custom pred matrix, use_img=False)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.d3qn import D3QNAgent, D3QNConfig, Replay
from repro_torch.sim.cemllm import Episode, Servers, greedy_latencies
from repro_torch.sim.cost_model import TIMEOUT_S
from repro_torch.sim.miobench import MIOBench

_NORM_T = TIMEOUT_S  # latency normalizer for net inputs


@dataclasses.dataclass
class QLMIOConfig:
    episodes: int = 600  # paper: 12000; scaled for CPU (converges earlier)
    users: int = 30
    use_milp: bool = True
    use_mgqp: bool = True
    use_task_features: bool = True
    use_img: bool = True
    seed: int = 0
    agent: D3QNConfig | None = None


class QLMIO:
    def __init__(self, bench: MIOBench, servers: Servers,
                 features: "tuple[np.ndarray, np.ndarray]",
                 milp_preds: np.ndarray, mgqp_preds: np.ndarray,
                 cfg: QLMIOConfig | None = None, device=None):
        """milp_preds / mgqp_preds: [n_tasks, n_server_classes]."""
        self.bench = bench
        self.servers = servers
        self.cfg = cfg or QLMIOConfig()
        self.f_img, self.f_text = features
        self.milp = milp_preds
        self.mgqp = mgqp_preds
        A = servers.n
        feat_dim = self.f_text.shape[1]
        agent_cfg = self.cfg.agent or D3QNConfig(seed=self.cfg.seed)
        self.agent = D3QNAgent(A, n_models=int(servers.model_id.max()) + 1,
                               n_devices=int(servers.device_id.max()) + 1,
                               cfg=agent_cfg, feat_dim=feat_dim,
                               use_task_features=self.cfg.use_task_features,
                               device=device)
        shapes = {"action": ((), np.int64), "reward": ((), np.float32),
                  "done": ((), np.float32)}
        for pre in ("s_", "n_"):
            if self.cfg.use_task_features:
                shapes[pre + "f_text"] = ((feat_dim,), np.float32)
                shapes[pre + "f_img"] = ((feat_dim,), np.float32)
            shapes[pre + "model_ids"] = ((A,), np.int64)
            shapes[pre + "device_ids"] = ((A,), np.int64)
            shapes[pre + "t_hat"] = ((A,), np.float32)
            shapes[pre + "q_load"] = ((A,), np.float32)
            shapes[pre + "b_hat"] = ((A,), np.float32)
        self.replay = Replay(agent_cfg.replay, shapes)
        self.rng = np.random.default_rng(self.cfg.seed)

    # ---------------------------------------------------------------- state
    def _state(self, task: int, pred_sum, pred_len) -> dict:
        """Eq. 18 state for the current task."""
        sv = self.servers
        cls = sv.cls
        t_hat = (self.milp[task, cls] / _NORM_T if self.cfg.use_milp
                 else np.zeros(sv.n))
        b_hat = (self.mgqp[task, cls] if self.cfg.use_mgqp
                 else np.zeros(sv.n))
        q_load = np.where(pred_len > 0, pred_sum / np.maximum(pred_len, 1),
                          0.0) / _NORM_T  # Eq. 19
        s = {"model_ids": sv.model_id, "device_ids": sv.device_id,
             "t_hat": t_hat.astype(np.float32),
             "q_load": q_load.astype(np.float32),
             "b_hat": b_hat.astype(np.float32)}
        if self.cfg.use_task_features:
            s["f_text"] = self.f_text[task]
            s["f_img"] = (self.f_img[task] if self.cfg.use_img
                          else np.zeros_like(self.f_img[task]))
        return s

    def _queue_pred_update(self, pred_sum, pred_len, task, action):
        # queue-load estimate uses MILP predictions when available, else the
        # running mean of observed latencies (plain-D3QN baseline behaviour)
        est = (self.milp[task, self.servers.cls[action]]
               if self.cfg.use_milp else 20.0)
        pred_sum[action] += est
        pred_len[action] += 1

    # ---------------------------------------------------------------- train
    def train(self, train_task_ids, verbose: bool = False,
              log_every: int = 20) -> "list[dict]":
        cfg, ag = self.cfg, self.agent
        history = []
        for episode in range(cfg.episodes):
            tasks = self.rng.choice(train_task_ids, cfg.users, replace=False)
            t_greedy = greedy_latencies(self.bench, self.servers, tasks)
            ep = Episode(self.bench, self.servers, tasks, self.rng)
            pred_sum = np.zeros(self.servers.n)
            pred_len = np.zeros(self.servers.n)
            rewards, lats, succ, losses = [], [], [], []
            state = self._state(int(tasks[0]), pred_sum, pred_len)
            for u in range(cfg.users):
                task = ep.current_task
                a = ag.act(state)
                rec = ep.step(a)
                self._queue_pred_update(pred_sum, pred_len, task, a)
                r_b = 1.0 if rec["success"] else -2.0  # Eq. 21
                r = 1.0 - rec["latency_total"] / max(t_greedy[u], 1e-6) + r_b
                done = float(u == cfg.users - 1)
                nxt = (self._state(int(tasks[u + 1]), pred_sum, pred_len)
                       if not done else state)
                item = {"action": a, "reward": r, "done": done}
                item.update({"s_" + k: v for k, v in state.items()})
                item.update({"n_" + k: v for k, v in nxt.items()})
                self.replay.add(item)
                ag.step_count += 1
                if (self.replay.n > ag.cfg.batch
                        and ag.step_count % ag.cfg.train_interval == 0):
                    losses.append(ag.train_step(
                        self.replay.sample(ag.cfg.batch, self.rng)))
                rewards.append(r)
                lats.append(rec["latency_total"])
                succ.append(rec["success"])
                state = nxt
            ag.soft_update()
            history.append({
                "episode": episode,
                "avg_reward": float(np.mean(rewards)),
                "avg_latency_s": float(np.mean(lats)),
                "completion_rate": float(np.mean(succ)),
                "loss": float(np.mean(losses)) if losses else float("nan"),
                "epsilon": ag.epsilon(),
            })
            if verbose and episode % log_every == 0:
                print(history[-1], flush=True)
        return history

    # ----------------------------------------------------------------- eval
    def evaluate(self, task_ids, users: int | None = None, trials: int = 1,
                 rng: np.random.Generator | None = None,
                 failed: np.ndarray | None = None) -> dict:
        users = users or self.cfg.users
        rng = rng or np.random.default_rng(1234)
        agg = {"avg_reward": [], "avg_latency_s": [], "completion_rate": []}
        for _ in range(trials):
            tasks = rng.choice(task_ids, users, replace=False)
            t_greedy = greedy_latencies(self.bench, self.servers, tasks)
            ep = Episode(self.bench, self.servers, tasks, rng, failed=failed)
            pred_sum = np.zeros(self.servers.n)
            pred_len = np.zeros(self.servers.n)
            rewards, lats, succ = [], [], []
            for u in range(users):
                task = ep.current_task
                state = self._state(task, pred_sum, pred_len)
                a = self.agent.act(state, greedy=True)
                rec = ep.step(a)
                self._queue_pred_update(pred_sum, pred_len, task, a)
                r_b = 1.0 if rec["success"] else -2.0
                rewards.append(1.0 - rec["latency_total"]
                               / max(t_greedy[u], 1e-6) + r_b)
                lats.append(rec["latency_total"])
                succ.append(rec["success"])
            agg["avg_reward"].append(np.mean(rewards))
            agg["avg_latency_s"].append(np.mean(lats))
            agg["completion_rate"].append(np.mean(succ))
        return {k: float(np.mean(v)) for k, v in agg.items()}
