"""Heuristic baselines of the paper (Sec. V-C): All-Cloud, Greedy and
Random, plain policies over the CEMLLM-Sim episode.

A copy of ``repro/core/baselines.py:27-50`` (numpy only).  The rest of
that module, the learning baselines (plain D3QN, SAC, QoS-Aware RL), reuses
the QLMIO training harness (``d3qn``, ``qlmio``) and comes with it
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.cemllm import Servers


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
