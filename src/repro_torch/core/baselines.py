"""Baselines (paper Sec. V-C): All-Cloud, Greedy, Random, plain D3QN,
SAC, QoS-Aware RL.

Port of ``repro/core/baselines.py``.  The heuristics are plain numpy
policies over the CEMLLM-Sim episode; the learning baselines reuse the
QLMIO training harness with degraded state (that is what makes them
baselines: no MILP/MGQP foresight, and for QoS-Aware RL no image modality
and a linear-regression latency estimate).  Their networks run on
``device`` (the card unless the caller says ``"cpu"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import qlmio as Q
from repro_torch.core.d3qn import (adam, clone_tree, q_values, qnet_spec,
                                   soft_update, split_batch, to_tensors)
from repro_torch.device import resolve
from repro_torch.nn.spec import init_params
from repro_torch.sim.cemllm import Episode, Servers, greedy_latencies
from repro_torch.sim.miobench import SERVER_CLASSES, MIOBench


# ------------------------------------------------------------- heuristics


def all_cloud_policy(servers: Servers):
    cloud = int(np.argmax(servers.is_cloud))

    def policy(ep):
        return cloud

    return policy


def greedy_policy():
    def policy(ep):
        return int(np.argmin(ep.queue_s))

    return policy


def random_policy(rng: np.random.Generator):
    def policy(ep):
        return int(rng.integers(ep.servers.n))

    return policy


# --------------------------------------------------------------- plain D3QN


def make_plain_d3qn(bench, servers, features, cfg=None, device=None
                    ) -> Q.QLMIO:
    """The D3QN baseline: no task features, no predictors."""
    cfg = cfg or Q.QLMIOConfig()
    cfg = dataclasses.replace(cfg, use_milp=False, use_mgqp=False,
                              use_task_features=False)
    zeros = np.zeros((bench.tasks.n, len(SERVER_CLASSES)), np.float32)
    return Q.QLMIO(bench, servers, features, zeros, zeros, cfg, device)


# --------------------------------------------------------------- QoS-RL


def linreg_latency(bench: MIOBench, train_ids) -> np.ndarray:
    """QoS-Aware RL's latency estimate: per-server-class linear regression on
    prompt length only (no multimodal features), its documented weakness."""
    x = bench.tasks.text_len.astype(np.float64)
    preds = np.zeros_like(bench.latency_s)
    for c in range(bench.latency_s.shape[1]):
        y = bench.latency_s[train_ids, c]
        xt = x[train_ids]
        A = np.stack([xt, np.ones_like(xt)], 1)
        w, *_ = np.linalg.lstsq(A, y, rcond=None)
        preds[:, c] = np.maximum(A_full(x) @ w, 0.05)
    return preds


def A_full(x):
    return np.stack([x, np.ones_like(x)], 1)


def make_qos_rl(bench, servers, features, train_ids, cfg=None, device=None
                ) -> Q.QLMIO:
    cfg = cfg or Q.QLMIOConfig()
    cfg = dataclasses.replace(cfg, use_mgqp=False, use_img=False)
    lin = linreg_latency(bench, train_ids).astype(np.float32)
    zeros = np.zeros_like(lin)
    return Q.QLMIO(bench, servers, features, lin, zeros, cfg, device)


# ------------------------------------------------------------------- SAC


@dataclasses.dataclass
class SACConfig:
    lr: float = 3e-4
    gamma: float = 0.95
    alpha: float = 0.05  # entropy temperature
    batch: int = 256
    train_interval: int = 5
    tau: float = 0.005
    seed: int = 0


class DiscreteSAC:
    """Discrete soft actor-critic over the plain (no-predictor) state, on
    ``device`` (the card unless the caller says ``"cpu"``).  The three
    networks are drawn under the paths ``/pi``, ``/q1`` and ``/q2``."""

    def __init__(self, n_actions, n_models, n_devices, cfg: SACConfig | None
                 = None, feat_dim: int = 768, device=None):
        self.cfg = cfg or SACConfig()
        self.n_actions = n_actions
        self.device = resolve(device)
        spec = qnet_spec(n_actions, n_models, n_devices, feat_dim,
                         use_task_features=False)
        nets = init_params({"pi": spec, "q1": spec, "q2": spec},
                           self.cfg.seed, device=self.device)
        self.pi, self.q1, self.q2 = nets["pi"], nets["q1"], nets["q2"]
        self.q1_t = clone_tree(self.q1)
        self.q2_t = clone_tree(self.q2)
        self.opt = {n: adam(p, self.cfg.lr) for n, p in
                    [("pi", self.pi), ("q1", self.q1), ("q2", self.q2)]}
        self.rng = np.random.default_rng(self.cfg.seed)
        self.step_count = 0

    def act(self, state: dict, greedy: bool = False) -> int:
        with torch.no_grad():
            logits = q_values(self.pi, to_tensors(
                {k: np.asarray(v)[None] for k, v in state.items()},
                self.device)).cpu().numpy()[0]
        if greedy:
            return int(np.argmax(logits))
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(self.n_actions, p=p))

    def _losses(self, batch):
        """(q1 loss, q2 loss, policy loss), each from the parameters
        before this step's update."""
        c = self.cfg
        s, s2, r, done, a = split_batch(batch, self.device)
        with torch.no_grad():
            logp2 = F.log_softmax(q_values(self.pi, s2), -1)
            qmin2 = torch.minimum(q_values(self.q1_t, s2),
                                  q_values(self.q2_t, s2))
            v2 = (logp2.exp() * (qmin2 - c.alpha * logp2)).sum(-1)
            y = r + c.gamma * (1 - done) * v2
        q1 = q_values(self.q1, s)
        q2 = q_values(self.q2, s)
        q_loss = [((q.gather(1, a[:, None])[:, 0] - y) ** 2).mean()
                  for q in (q1, q2)]
        logp = F.log_softmax(q_values(self.pi, s), -1)
        qmin = torch.minimum(q1, q2).detach()
        pi_loss = (logp.exp() * (c.alpha * logp - qmin)).sum(-1).mean()
        return q_loss[0], q_loss[1], pi_loss

    def train_step(self, batch) -> float:
        losses = self._losses(batch)
        for name, loss in zip(("q1", "q2", "pi"), losses):
            self.opt[name].zero_grad()
            loss.backward()
        for name in ("q1", "q2", "pi"):
            self.opt[name].step()
        soft_update(self.q1_t, self.q1, self.cfg.tau)
        soft_update(self.q2_t, self.q2, self.cfg.tau)
        return float(losses[2].detach())

    def soft_update(self):
        pass  # folded into train_step

    def epsilon(self):
        return 0.0

    @property
    def cfg_batch(self):
        return self.cfg.batch


def make_sac(bench, servers, features, cfg: Q.QLMIOConfig | None = None,
             device=None) -> Q.QLMIO:
    """SAC baseline wrapped in the QLMIO harness (plain state)."""
    qcfg = cfg or Q.QLMIOConfig()
    qcfg = dataclasses.replace(qcfg, use_milp=False, use_mgqp=False,
                               use_task_features=False)
    zeros = np.zeros((bench.tasks.n, len(SERVER_CLASSES)), np.float32)
    framework = Q.QLMIO(bench, servers, features, zeros, zeros, qcfg, device)
    sac = DiscreteSAC(servers.n, int(servers.model_id.max()) + 1,
                      int(servers.device_id.max()) + 1,
                      SACConfig(seed=qcfg.seed), device=device)
    # splice the SAC agent in: reuse the replay/state machinery
    framework.agent = _SACAdapter(sac, framework.agent.cfg)
    return framework


class _SACAdapter:
    """Duck-type the D3QNAgent interface for the QLMIO harness."""

    def __init__(self, sac: DiscreteSAC, d3qn_cfg):
        self.sac = sac
        self.cfg = d3qn_cfg
        self.step_count = 0

    def act(self, state, greedy=False):
        return self.sac.act(state, greedy=greedy)

    def train_step(self, batch):
        return self.sac.train_step(batch)

    def soft_update(self):
        pass

    def epsilon(self):
        return 0.0


def evaluate_heuristics(bench, servers, task_ids, users, trials, seed=1234):
    """All-Cloud / Greedy / Random metrics + the paper's reward for them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, make in [("all_cloud", lambda: all_cloud_policy(servers)),
                       ("greedy", greedy_policy),
                       ("random", lambda: random_policy(rng))]:
        lat, succ, rew = [], [], []
        for _ in range(trials):
            tasks = rng.choice(task_ids, users, replace=False)
            tg = greedy_latencies(bench, servers, tasks)
            ep = Episode(bench, servers, tasks, rng)
            pol = make()
            for u in range(users):
                rec = ep.step(pol(ep))
                r_b = 1.0 if rec["success"] else -2.0
                rew.append(1.0 - rec["latency_total"] / max(tg[u], 1e-6) + r_b)
                lat.append(rec["latency_total"])
                succ.append(rec["success"])
        out[name] = {"avg_latency_s": float(np.mean(lat)),
                     "completion_rate": float(np.mean(succ)),
                     "avg_reward": float(np.mean(rew))}
    return out
